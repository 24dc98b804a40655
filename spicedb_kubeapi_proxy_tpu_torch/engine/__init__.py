"""The relationship-graph engine: interning, the columnar store, the plain
host evaluator and the query :class:`Engine` over the device fixpoint."""

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
from .evaluator import OracleEvaluator  # noqa: F401
from .engine import CheckItem, Engine  # noqa: F401
