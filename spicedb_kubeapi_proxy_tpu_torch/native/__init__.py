"""ctypes loader for the native graph-builder core (graphcore.cpp).

Host code, not a device kernel: it keeps a 10M-relationship bulk load and
graph compile at tens of seconds, and scans kube list bodies for the
proxy's response filter (``authz/filterer.py``) without ``json.loads``. The shared library is built on first use
with the system toolchain into the git-ignored ``build/native/`` directory.
Every entry point degrades to a numpy fallback when the toolchain or
library is unavailable, and ``SDBKP_NATIVE=0`` disables the native path
outright — the numpy and native implementations are behaviorally identical.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .. import BUILD_ROOT

log = logging.getLogger("sdbkp.torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "graphcore.cpp")
_LIB = os.path.join(BUILD_ROOT, "native", "libgraphcore.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

# bumped together with graphcore_abi_version() in graphcore.cpp on ANY
# exported-signature change; _bind refuses a mismatching cached .so
_ABI_VERSION = 2


def _build() -> bool:
    # build to a private temp path and publish atomically: a killed or
    # concurrent compile must never leave a truncated .so behind
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native build failed (%s); using numpy fallbacks", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's signature; raises AttributeError when
    the library predates a symbol or its ABI version differs."""
    lib.graphcore_abi_version.restype = ctypes.c_int64
    lib.graphcore_abi_version.argtypes = []
    got = lib.graphcore_abi_version()
    if got != _ABI_VERSION:
        raise AttributeError(
            f"graphcore ABI {got} != expected {_ABI_VERSION}")
    lib.unique_inverse_fixed.restype = ctypes.c_int64
    lib.unique_inverse_fixed.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sort_perm_i64.restype = None
    lib.sort_perm_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.index_build_u64.restype = None
    lib.index_build_u64.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.json_list_spans.restype = ctypes.c_int64
    lib.json_list_spans.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.proto_list_spans.restype = ctypes.c_int64
    lib.proto_list_spans.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.proto_table_spans.restype = ctypes.c_int64
    lib.proto_table_spans.argtypes = lib.proto_list_spans.argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("SDBKP_NATIVE", "1") == "0":
            _load_failed = True
            return None
        stale = not os.path.exists(_LIB) or (
            os.path.getmtime(_SRC) > os.path.getmtime(_LIB))
        if stale and not _build():
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB))
        except (OSError, AttributeError) as e:
            # a cached library from an older source: rebuild once, then
            # degrade to numpy as documented instead of crashing callers
            log.warning("native load failed (%s); rebuilding", e)
            try:
                _lib = _bind(ctypes.CDLL(_LIB)) if _build() else None
            except (OSError, AttributeError) as e2:
                log.warning("native reload failed (%s); using numpy "
                            "fallbacks", e2)
                _lib = None
            _load_failed = _lib is None
        return _lib


def available() -> bool:
    return _load() is not None


def unique_inverse(arr: np.ndarray):
    """Hash-based ``np.unique(arr, return_inverse=True)`` over a bytes ('S')
    column, except uniques come back in FIRST-OCCURRENCE order (callers never
    depend on ordering). Returns (uniq_rows int64[k], inv int32[n]) or None
    when the native path does not apply."""
    lib = _load()
    if lib is None or arr.dtype.kind != "S" or arr.ndim != 1:
        return None
    width = arr.dtype.itemsize
    n = len(arr)
    if width == 0 or n == 0:
        return None
    data = np.ascontiguousarray(arr)
    inv = np.empty(n, dtype=np.int32)
    uniq_rows = np.empty(n, dtype=np.int64)
    k = lib.unique_inverse_fixed(
        data.ctypes.data_as(ctypes.c_char_p), width, n,
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        uniq_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return uniq_rows[:k], inv


def index_build(rt, rid, rl, st, sid, srl):
    """Row-key index build for the relationship store: hashes the six
    int32 key columns (same mix as store._hash_key_cols) and returns
    (sorted_hashes uint64[n], order int64[n]) via a multithreaded radix
    sort. None when the native path does not apply."""
    lib = _load()
    if lib is None:
        return None
    cols = [np.ascontiguousarray(c, dtype=np.int32)
            for c in (rt, rid, rl, st, sid, srl)]
    n = len(cols[0])
    hashes = np.empty(n, dtype=np.uint64)
    order = np.empty(n, dtype=np.int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.index_build_u64(
        *(c.ctypes.data_as(p32) for c in cols), n,
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return hashes, order


def json_list_spans(body: bytes, items_key: bytes = b"items",
                    nested: bool = False):
    """One-pass scan of a kube List response body (graphcore.cpp
    json_list_spans): returns ``(kind, arr_span, item_spans, keys)`` —
    kind as bytes (b"" when absent), spans as int64 arrays of byte
    offsets into ``body`` (``arr_span[0] < 0`` when ``items_key`` is
    absent), and ``keys`` as one packed bytes buffer of per-item records
    ``[esc '0'|'1'] ns_raw 0x1f name_raw 0x1e`` (raw = undecoded string
    content; JSON forbids unescaped control bytes, so the separators
    cannot collide) — or None when the native path does not apply or the
    scanner bailed (caller falls back to json.loads; the scanner is
    strictly conservative). ``nested`` reads each item's metadata from
    ``item["object"]`` instead of the item itself (Table rows)."""
    lib = _load()
    if lib is None or not isinstance(body, bytes) or not body:
        return None
    # every object item contains at least one '{': a cheap upper bound
    max_items = body.count(b"{") + 1
    kind_span = np.empty(2, dtype=np.int64)
    arr_span = np.empty(2, dtype=np.int64)
    item_spans = np.empty(2 * max_items, dtype=np.int64)
    key_buf = ctypes.create_string_buffer(len(body) + 3 * max_items + 16)
    key_len = ctypes.c_int64(0)
    p64 = ctypes.POINTER(ctypes.c_int64)
    count = lib.json_list_spans(
        body, len(body), items_key,
        kind_span.ctypes.data_as(p64), arr_span.ctypes.data_as(p64),
        item_spans.ctypes.data_as(p64), key_buf,
        ctypes.byref(key_len), 1 if nested else 0, max_items)
    if count < 0:
        return None
    kind = body[kind_span[0]:kind_span[1]] if kind_span[0] >= 0 else b""
    return (kind, arr_span, item_spans[:2 * count].reshape(-1, 2),
            ctypes.string_at(key_buf, key_len.value))


def proto_list_spans(raw: bytes):
    """One-pass scan of a kube-protobuf *List MESSAGE (the Unknown
    envelope's raw field): returns ``(item_spans, keys)`` — full-chunk
    spans (tag included) of every repeated ``items`` element, and the
    same packed key-record buffer the JSON scanner emits
    (``'0' ns 0x1f name 0x1e``; first-occurrence field semantics like
    kubeproto._field) — or None when the native path does not apply or
    the scanner bailed (truncated wire data, control bytes or invalid
    utf-8 in a name: the Python walker keeps authority)."""
    return _proto_spans(raw, "proto_list_spans")


def proto_table_spans(raw: bytes):
    """Like :func:`proto_list_spans` but for a meta.k8s.io Table MESSAGE:
    spans of repeated ``rows`` (field 3), keys from each row's
    ``object`` RawExtension (nested magic-prefixed Unknown or bare
    PartialObjectMetadata — kubeproto.table_row_meta semantics). Bails
    when any row has no keyable object or an empty name (the Python
    walker raises ProtoError there and keeps authority)."""
    return _proto_spans(raw, "proto_table_spans")


def _proto_spans(raw: bytes, fn_name: str):
    lib = _load()
    if lib is None or not isinstance(raw, bytes) or not raw:
        return None
    # start with a realistic bound (items are tens of bytes) and grow on
    # the scanner's overflow code — a degenerate body of 2-byte items
    # would otherwise force a huge upfront allocation
    max_items = len(raw) // 64 + 1024
    p64 = ctypes.POINTER(ctypes.c_int64)
    fn = getattr(lib, fn_name)
    while True:
        item_spans = np.empty(2 * max_items, dtype=np.int64)
        key_buf = ctypes.create_string_buffer(
            len(raw) + 3 * max_items + 16)
        key_len = ctypes.c_int64(0)
        count = fn(
            raw, len(raw), item_spans.ctypes.data_as(p64), key_buf,
            ctypes.byref(key_len), max_items)
        if count == -2 and max_items < len(raw) // 2 + 2:
            max_items = min(max_items * 4, len(raw) // 2 + 2)
            continue
        if count < 0:
            return None
        return (item_spans[:2 * count].reshape(-1, 2),
                ctypes.string_at(key_buf, key_len.value))


def sort_perm(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable ascending argsort of non-negative int64 keys (LSD radix).
    Returns None when the native path does not apply."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.ndim != 1 or (len(keys) and keys.min() < 0):
        return None
    perm = np.empty(len(keys), dtype=np.int64)
    lib.sort_perm_i64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(keys),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm
