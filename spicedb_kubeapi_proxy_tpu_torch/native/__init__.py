"""ctypes loader for the native graph-builder core (graphcore.cpp).

Host code, not a device kernel: it keeps a 10M-relationship bulk load and
graph compile at tens of seconds. The shared library is built on first use
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
_ABI_VERSION = 1


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
