"""The relationship-graph engine: interning, the columnar store, the plain
host evaluator, the decision cache and the query :class:`Engine` over the
device fixpoint."""

from .interning import Interner  # noqa: F401
from .store import (  # noqa: F401
    Columns,
    Precondition,
    PreconditionFailed,
    RelationshipFilter,
    Store,
    StoreError,
    WriteOp,
)
from .decision_cache import DecisionCache  # noqa: F401
from .evaluator import OracleEvaluator  # noqa: F401
from .engine import CheckItem, Engine, WatchEvent  # noqa: F401
