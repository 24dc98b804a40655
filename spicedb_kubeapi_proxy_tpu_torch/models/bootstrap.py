"""Bootstrap file handling: ``{schema: <DSL>, relationships: <tuple lines>}``.

A copy of the JAX package's ``models/bootstrap.py`` (the same YAML shape an
embedded SpiceDB is fed; ``deploy/bootstrap.yaml``). Multiple documents are
allowed; schemas are concatenated and relationships appended.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import yaml

from .schema import Schema, parse_schema
from .tuples import Relationship, parse_relationship

# The proxy's own bookkeeping types (locks, idempotency keys). parse_bootstrap appends any of these definitions a caller-provided
# schema is missing, so the dual-write engine's lock/idempotency tuples always
# validate.
WORKFLOW_DEFS = {
    "lock": "definition lock {\n  relation workflow: workflow\n}\n",
    "workflow": (
        "definition workflow {\n"
        "  relation idempotency_key: activity with expiration\n"
        "}\n"
    ),
    "activity": "definition activity {}\n",
}
WORKFLOW_SCHEMA = "\n".join(WORKFLOW_DEFS.values())

DEFAULT_BOOTSTRAP = """
schema: |-
  use expiration

  definition cluster {}
  definition user {}
  definition namespace {
    relation cluster: cluster
    relation creator: user
    relation viewer: user

    permission admin = creator
    permission edit = creator
    permission view = viewer + creator
    permission no_one_at_all = nil
  }
  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    permission edit = creator
    permission view = viewer + creator
  }
  definition lock {
    relation workflow: workflow
  }
  definition workflow {
    relation idempotency_key: activity with expiration
  }
  definition activity {}
relationships: ""
"""


@dataclass
class Bootstrap:
    schema: Schema
    schema_text: str
    relationships: list[Relationship] = field(default_factory=list)


def parse_bootstrap(text: str) -> Bootstrap:
    schema_parts: list[str] = []
    rels: list[Relationship] = []
    for doc in yaml.safe_load_all(text):
        if doc is None:
            continue
        if not isinstance(doc, dict):
            raise ValueError("bootstrap document must be a mapping")
        if doc.get("schema"):
            schema_parts.append(str(doc["schema"]))
        rel_text = doc.get("relationships") or ""
        for line in str(rel_text).splitlines():
            line = line.strip()
            if not line or line.startswith("//") or line.startswith("#"):
                continue
            rels.append(parse_relationship(line))
    if not schema_parts:
        raise ValueError("bootstrap contains no schema")
    schema_text = "\n".join(schema_parts)
    missing = [
        name
        for name in ("lock", "workflow", "activity")
        if not re.search(rf"definition\s+{name}\b", schema_text)
    ]
    if missing:
        schema_text = "\n".join([schema_text] + [WORKFLOW_DEFS[n] for n in missing])
    schema = parse_schema(schema_text)
    # Caveated tuples LOAD with their contexts: conditional grants are
    # enforced on the device by the caveat VM (caveats/), resolving at
    # check time against tuple ∪ request context and failing closed on
    # missing context. Only DECLARED caveats are accepted: an unknown
    # bracket trait is far more likely a typo (e.g. [expiry:...] for
    # [expiration:...]), and silently dropping the grant would be a
    # quiet access revocation.
    for rel in rels:
        if rel.caveat and rel.caveat not in schema.caveats:
            raise ValueError(
                f"relationship {rel} carries unknown trait "
                f"[{rel.caveat}...]: no such caveat is declared in "
                "the schema — refusing to guess (a misspelled "
                "expiration would silently drop the grant)")
    return Bootstrap(schema, schema_text, rels)
