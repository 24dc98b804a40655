"""The port's list-span scanners against the JAX package's.

``native/graphcore.cpp``'s ``json_list_spans``, ``proto_list_spans`` and
``proto_table_spans`` scan a kube list body once for each item's byte span
and its (namespace, name) key, so the response filter
(``authz/filterer.py``) keeps items byte for byte without decoding the
body. The port builds its own copy of the source; here both libraries get
the same bodies (fixed ones, bail cases included, and hypothesis-generated
ones) and must return the same spans, kinds and key records, or both bail
(tolerance: exact). ``filter_body`` must give byte-equal output at 10k
items, through the native path on both sides.
"""

from __future__ import annotations

import json
import random
import string

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spicedb_kubeapi_proxy_tpu import native as jn
from spicedb_kubeapi_proxy_tpu.authz import filterer as jf
from spicedb_kubeapi_proxy_tpu.authz.lookups import AllowedSet as JAllowed
from spicedb_kubeapi_proxy_tpu.rules.input import (
    RequestInfo as JRequestInfo,
    ResolveInput as JResolveInput,
    UserInfo as JUserInfo,
)
from spicedb_kubeapi_proxy_tpu_torch import native as tn
from spicedb_kubeapi_proxy_tpu_torch.authz import filterer as tf
from spicedb_kubeapi_proxy_tpu_torch.authz.lookups import AllowedSet as TAllowed
from spicedb_kubeapi_proxy_tpu_torch.rules.input import (
    RequestInfo as TRequestInfo,
    ResolveInput as TResolveInput,
    UserInfo as TUserInfo,
)



@pytest.fixture(autouse=True)
def _native_built():
    if not (jn.available() and tn.available()):
        pytest.skip("a native library did not build (g++ missing)")

NAMES = ["plain", "with/slash", 'quo"te', "back\\slash", "uni-日本",
         "tab\there", "new\nline", " sep", "na\x00me", ""]


def same(a, b) -> bool:
    """Two scanner results agree: both bailed, or every part is equal."""
    if a is None or b is None:
        return a is None and b is None
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def both_json(body: bytes) -> None:
    for key, nested in ((b"items", False), (b"rows", True)):
        got = (jn.json_list_spans(body, key, nested),
               tn.json_list_spans(body, key, nested))
        assert same(*got), (body, key, got)


def both_proto(raw: bytes) -> None:
    for fn in ("proto_list_spans", "proto_table_spans"):
        got = (getattr(jn, fn)(raw), getattr(tn, fn)(raw))
        assert same(*got), (fn, raw, got)


# -- JSON ---------------------------------------------------------------------

FIXED_JSON = [
    b'{"kind":"PodList", "items":[\n'
    b'  {"metadata":{"name":"a","namespace":"n1"},"x":1.50},\n'
    b'  {"metadata":{"namespace":"n2","name":"b"}}\n]}',
    json.dumps({"kind": "PodList", "items": [
        {"metadata": {"name": 'quo"te\\pathé\n', "namespace": "ns"}}]
    }).encode(),
    b'{"kind":"Table","rows":[{"cells":["a"],"object":'
    b'{"metadata":{"name":"a"}}},{"cells":["b"]}]}',
    b'{"kind":"PodList","metadata":{"resourceVersion":"7"}}',
    b'{"items":[]}',
    # the JAX suite's bail cases (tests/test_native_json.py)
    b'{"items":[1,2]}',
    b'{"items":[{}],"items":[{}]}',
    b'{"items":[{}]} trailing',
    b'{"items":[{"metadata":{"name":123}}]}',
    b'{"items":[{"metadata":{"na\\u006de":"x"}}]}',
    b'not json at all',
    b'{"kind":"Pod","metadata":{"name":"x"}}',
    b'[1,2,3]',
    b'{"kind":"PodList","items":[{"metadata":{"name":"x"},"spec":{"a":@@@}}]}',
    b'{"kind":"PodList","items":[{"metadata":{"name":"x"},"n":1e+e+5}]}',
    b'{"kind":"PodList","items":[{"metadata":{"name":"x"},"n":01}]}',
    b'{"kind":"PodList","items":[{"metadata":{"name":"x"},"n":+1}]}',
    b'{"kind":"PodList","items":[{"metadata":{"name":"a\\qb"}}]}',
    b'{"kind":"PodList","items":[{"metadata":'
    b'{"name":"a\\tb","namespace":"\xff\xfe"}}]}',
]


@pytest.mark.parametrize("body", FIXED_JSON)
def test_json_spans_match_on_fixed_bodies(body):
    both_json(body)


def _rand_value(rng, depth=0):
    r = rng.random()
    if depth > 2 or r < 0.3:
        return rng.choice([1, -2.5, 1e10, True, False, None, "s",
                           'esc"aped', "unié", rng.random()])
    if r < 0.55:
        return [_rand_value(rng, depth + 1) for _ in range(rng.randrange(3))]
    return {f"k{i}": _rand_value(rng, depth + 1)
            for i in range(rng.randrange(3))}


def _rand_list(rng, table: bool) -> bytes:
    items = []
    for _ in range(rng.randrange(6)):
        meta = {}
        if rng.random() < 0.9:
            meta["name"] = rng.choice(NAMES)
        if rng.random() < 0.6:
            meta["namespace"] = rng.choice(NAMES)
        if rng.random() < 0.5:
            meta["labels"] = {"".join(rng.choices(string.ascii_letters, k=3)):
                              _rand_value(rng)}
        item = {"metadata": meta}
        if rng.random() < 0.5:
            item["spec"] = _rand_value(rng)
        if rng.random() < 0.2:
            del item["metadata"]
        if table:
            item = {"cells": [meta.get("name", "")], "object": item}
        items.append(item)
    doc = {"kind": "Table" if table else "PodList", "apiVersion": "v1",
           "metadata": {"resourceVersion": "7"},
           ("rows" if table else "items"): items}
    if rng.random() < 0.3:
        doc["extra"] = _rand_value(rng)
    sep = rng.choice([(",", ":"), (", ", ": "), (",\n ", " : ")])
    return json.dumps(doc, separators=sep,
                      ensure_ascii=rng.random() < 0.5).encode()


@settings(max_examples=150, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), table=st.booleans(),
       cut=st.integers(0, 64))
def test_json_spans_match_on_generated_bodies(seed, table, cut):
    body = _rand_list(random.Random(seed), table)
    both_json(body)
    # truncated and spliced bodies: both must bail, or agree
    both_json(body[:max(1, len(body) - cut)])
    both_json(body.replace(b":", b"", cut % 3))


@settings(max_examples=150, deadline=None)
@given(st.binary(min_size=1, max_size=200))
def test_json_spans_match_on_arbitrary_bytes(body):
    both_json(body)
    both_json(b'{"kind":"PodList","items":[' + body + b"]}")


# -- protobuf -------------------------------------------------------------------


def _ld(field_no: int, payload: bytes) -> bytes:
    n, out = len(payload), bytearray([(field_no << 3) | 2])
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out) + payload


def _meta(name: bytes, ns: bytes) -> bytes:
    return _ld(1, name) + (_ld(3, ns) if ns else b"")


def _proto_list(names) -> bytes:
    raw = _ld(1, _ld(2, b"rv9"))
    for name, ns in names:
        raw += _ld(2, _ld(1, _meta(name, ns)) + _ld(2, b"\x0a\x01x"))
    return raw


def _proto_table(names, nested: bool) -> bytes:
    raw = _ld(1, _ld(2, b"rv9"))
    for name, ns in names:
        pom = _ld(1, _meta(name, ns))
        if nested:
            pom = (b"k8s\x00" + _ld(1, _ld(1, b"meta.k8s.io/v1")
                                   + _ld(2, b"PartialObjectMetadata"))
                   + _ld(2, pom))
        raw += _ld(3, _ld(1, _ld(1, b'"c"')) + _ld(3, _ld(1, pom)))
    return raw


PNAMES = [b"a", b"web-1", "uni-日".encode(), b"", b"ctl\x01x",
          b"\xff\xfebad", b"x" * 300]


def test_proto_spans_match_on_fixed_bodies():
    pairs = [(n, ns) for n in PNAMES for ns in (b"", b"ns", b"\x1f")]
    for k in range(len(pairs)):
        both_proto(_proto_list(pairs[k:k + 3]))
        both_proto(_proto_table(pairs[k:k + 3], nested=k % 2 == 0))
    both_proto(b"\x0a\x00")
    both_proto(_proto_list([(b"a", b"n")])[:-1])  # truncated


@settings(max_examples=150, deadline=None)
@given(names=st.lists(st.tuples(st.sampled_from(PNAMES),
                                st.sampled_from([b"", b"ns", b"k\x00"])),
                      max_size=6),
       nested=st.booleans(), cut=st.integers(0, 16))
def test_proto_spans_match_on_generated_bodies(names, nested, cut):
    for raw in (_proto_list(names), _proto_table(names, nested)):
        both_proto(raw)
        both_proto(raw[:max(1, len(raw) - cut)])


@settings(max_examples=150, deadline=None)
@given(st.binary(min_size=1, max_size=200))
def test_proto_spans_match_on_arbitrary_bytes(raw):
    both_proto(raw)


# -- filter_body at 10k items ----------------------------------------------------


def test_filter_body_is_byte_equal_at_10k_items(monkeypatch):
    rng = random.Random(5)
    items = [{"metadata": {"name": f"p{i}", "namespace": f"ns{i % 97}",
                           "uid": f"u{i}"},
              "spec": {"n": rng.random(), "tags": ["a", "b"][:i % 3]}}
             for i in range(10_000)]
    body = json.dumps({"kind": "PodList", "apiVersion": "v1",
                       "metadata": {"resourceVersion": "3"},
                       "items": items}).encode()
    keep = {(f"ns{i % 97}", f"p{i}") for i in range(10_000)
            if rng.random() < 0.5}
    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jn), ("port", tn)):
        orig = mod.json_list_spans

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "json_list_spans", spy)
    info = dict(verb="list", api_version="v1", resource="pods",
                path="/api/v1/pods")
    j = jf.filter_body(body, JAllowed(set(keep)), JResolveInput.create(
        JRequestInfo(**info), JUserInfo(name="a")))
    t = tf.filter_body(body, TAllowed(set(keep)), TResolveInput.create(
        TRequestInfo(**info), TUserInfo(name="a")))
    assert t == j
    assert t[0] == 200
    assert calls == {"jax": 1, "port": 1}
    kept = json.loads(t[1])["items"]
    assert len(kept) == len(keep)
    # each kept item's bytes are the upstream's, spliced as they were
    assert json.dumps(kept[0]).encode() in body


def test_python_path_is_counted():
    """A body the scanner bails on takes the Python path, and the port
    counts it (``proxy_filter_python_path_total``); a scanned one does
    not."""
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    c = metrics.counter("proxy_filter_python_path_total", format="json")
    inp = TResolveInput.create(
        TRequestInfo(verb="list", api_version="v1", resource="pods",
                     path="/api/v1/pods"), TUserInfo(name="a"))
    allowed = TAllowed({("n", "a")})
    before = c.value
    tf.filter_body(FIXED_JSON[0], allowed, inp)
    assert c.value == before
    bail = b'{"kind":"PodList","items":[{"metadata":{"na\\u006de":"a"}}]}'
    assert tn.json_list_spans(bail) is None
    tf.filter_body(bail, allowed, inp)
    assert c.value == before + 1
