"""Schema models: the Zanzibar-style schema DSL parser, typed IR, tuples
and bootstraps (copies of the JAX package's ``models/``)."""

from .schema import (  # noqa: F401
    AllowedSubject,
    Arrow,
    Definition,
    Exclude,
    Expr,
    Intersect,
    Nil,
    Permission,
    Relation,
    RelationRef,
    Schema,
    SchemaError,
    Union,
    parse_schema,
)
from .bootstrap import parse_bootstrap, Bootstrap  # noqa: F401
