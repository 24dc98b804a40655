"""Caveats: conditional grants evaluated on the device.

Counterpart of the JAX package's ``caveats/``. A SpiceDB caveat is a CEL
expression attached to relationships; a caveated tuple takes part in a
check only when its expression holds under the union of the tuple's
stored context and the request's context (missing context fails
CLOSED). Each caveat compiles into a flat op tape that the VM evaluates
for every distinct (caveat, context) instance once per fixpoint dispatch,
so the per-instance tri-state (grant / deny / missing context) gates the
edges of the same dispatch.

- :mod:`.ast`: the expression grammar, parser and the pure-Python
  tri-state interpreter (the VM's differential oracle), copied;
- :mod:`.compile`: constant folding and lowering to the register tape,
  copied;
- :mod:`.vm`: the host-side instance tables and request encoder
  (copied) and the PyTorch evaluator.
"""

from .ast import (  # noqa: F401
    CaveatDef,
    CaveatError,
    CaveatParam,
    interpret,
    parse_caveat_body,
)
from .compile import CaveatProgram, compile_caveat  # noqa: F401
from .vm import CompiledCaveats, build_caveat_table  # noqa: F401
