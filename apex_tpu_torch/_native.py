"""ctypes loader of the native host runtime (counterpart of
apex_tpu/_native.py).

The library is the port's own copy of the JAX package's C++ host runtime,
``apex_tpu_torch/csrc/apex_tpu_C.cpp`` (the same plain C ABI, version 2):
the data loader's batched row gather out of a memory-mapped token file
(striped over threads for large batches), apex_C's flatten/unflatten
over host fp32 buffers, the splitmix64 Fisher-Yates epoch shuffle and
the LM sample offsets. It is built with ``g++ -O3 -shared -fPIC
-std=c++17`` at first use into the kernels' hash-keyed cache under
``build/apex_tpu_torch/`` (``_kernels.host_library``) and opened once a
process.

The JAX package falls back to numpy when its library does not build.
This one does not: as a CUDA tensor goes to its kernel or raises, every
function here runs the library or raises — when ``g++`` is missing, the
build fails, the library does not open or its ABI version differs — so
a run never carries on quietly on another implementation. The bounds
checks and their errors are the JAX wrappers'.
"""

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from apex_tpu_torch import _kernels

__all__ = ["ABI_VERSION", "flatten", "gather_rows", "library",
           "lm_sample_offsets", "permutation", "unflatten"]

#: the C ABI this wrapper speaks (``apex_tpu_native_abi_version()``)
ABI_VERSION = 2
_SOURCE = "apex_tpu_C"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_p = ctypes.POINTER


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # the version gate first: a library of another ABI may lack the
    # newer symbols
    try:
        version_fn = lib.apex_tpu_native_abi_version
    except AttributeError:
        raise RuntimeError(f"the native library has no ABI version "
                           f"symbol; this wrapper speaks {ABI_VERSION}")
    version_fn.restype = _i64
    version = version_fn()
    if version != ABI_VERSION:
        raise RuntimeError(f"the native library speaks ABI {version}; this "
                           f"wrapper speaks {ABI_VERSION}")
    lib.gather_rows_i32_mt.argtypes = [
        _p(ctypes.c_int32), _p(_i64), _i64, _i64, _p(ctypes.c_int32), _i64]
    lib.gather_rows_u16_mt.argtypes = [
        _p(ctypes.c_uint16), _p(_i64), _i64, _i64, _p(ctypes.c_uint16), _i64]
    lib.flatten_f32.argtypes = [
        _p(_p(ctypes.c_float)), _p(_i64), _i64, _p(ctypes.c_float)]
    lib.unflatten_f32.argtypes = [
        _p(ctypes.c_float), _p(_i64), _i64, _p(_p(ctypes.c_float))]
    lib.permutation_i64.argtypes = [_i64, _u64, _p(_i64)]
    lib.build_lm_sample_offsets.argtypes = [_i64, _i64, _p(_i64), _i64]
    lib.build_lm_sample_offsets.restype = _i64
    return lib


def library() -> ctypes.CDLL:
    """The host library, built at the first call of the process and
    opened once; raises when it cannot be built, opened or its ABI
    version is not :data:`ABI_VERSION`."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(_kernels.host_library(_SOURCE))
        return _LIB


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(_p(_i64))


# staging batches past ~8 MB get striped over threads (host DRAM bandwidth
# spans cores); below that the spawn cost exceeds the copy
_MT_BYTES_THRESHOLD = 8 << 20
_MT_THREADS = min(8, os.cpu_count() or 1)
_GATHER = {np.dtype(np.int32): ("gather_rows_i32_mt", ctypes.c_int32),
           np.dtype(np.uint16): ("gather_rows_u16_mt", ctypes.c_uint16)}


def gather_rows(data: np.ndarray, offsets: np.ndarray,
                row_len: int) -> np.ndarray:
    """out[i] = data[offsets[i] : offsets[i]+row_len]; data 1-D int32 or
    uint16 (another dtype raises ``TypeError``).

    The data-loader hot path: one native memcpy per sample out of the
    token memmap (threaded across cores for large batches)."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = offsets.shape[0]
    if np.any(offsets < 0) or np.any(offsets + row_len > data.shape[0]):
        raise IndexError("gather_rows: offsets out of bounds")
    if data.dtype not in _GATHER:
        raise TypeError(f"gather_rows takes int32 or uint16 tokens, got "
                        f"{data.dtype}")
    symbol, ctype = _GATHER[data.dtype]
    fn = getattr(library(), symbol)
    data = np.ascontiguousarray(data)
    out = np.empty((n, row_len), data.dtype)
    threads = (_MT_THREADS if out.nbytes >= _MT_BYTES_THRESHOLD
               and _MT_THREADS > 1 else 1)
    fn(data.ctypes.data_as(_p(ctype)), _i64ptr(offsets), n, row_len,
       out.ctypes.data_as(_p(ctype)), threads)
    return out


def flatten(buffers: List[np.ndarray]) -> np.ndarray:
    """apex_C.flatten over host fp32 buffers."""
    bufs = [np.ascontiguousarray(b, np.float32) for b in buffers]
    sizes = np.asarray([b.size for b in bufs], np.int64)
    lib = library()
    out = np.empty((int(sizes.sum()),), np.float32)
    ptrs = (_p(ctypes.c_float) * len(bufs))(
        *[b.ctypes.data_as(_p(ctypes.c_float)) for b in bufs])
    lib.flatten_f32(ptrs, _i64ptr(sizes), len(bufs),
                    out.ctypes.data_as(_p(ctypes.c_float)))
    return out


def unflatten(flat: np.ndarray, shapes: List[tuple]) -> List[np.ndarray]:
    """apex_C.unflatten: new fp32 arrays of ``shapes`` from ``flat``'s
    leading elements."""
    flat = np.ascontiguousarray(flat, np.float32)
    sizes = np.asarray([int(np.prod(s)) if s else 1 for s in shapes],
                       np.int64)
    if int(sizes.sum()) > flat.size:
        raise ValueError("unflatten: shapes exceed flat buffer")
    lib = library()
    outs = [np.empty(s, np.float32) for s in shapes]
    ptrs = (_p(ctypes.c_float) * len(outs))(
        *[o.ctypes.data_as(_p(ctypes.c_float)) for o in outs])
    lib.unflatten_f32(flat.ctypes.data_as(_p(ctypes.c_float)),
                      _i64ptr(sizes), len(outs), ptrs)
    return outs


def permutation(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates shuffle of ``range(n)`` driven by
    splitmix64 (the epoch shuffle; the JAX package's, bit for bit)."""
    lib = library()
    out = np.empty((n,), np.int64)
    lib.permutation_i64(n, seed, _i64ptr(out))
    return out


def lm_sample_offsets(n_tokens: int, seq_len: int) -> np.ndarray:
    """Start offsets of fixed-length LM samples over a token stream."""
    max_out = max((n_tokens - 1) // seq_len, 0)
    lib = library()
    out = np.empty((max_out,), np.int64)
    n = lib.build_lm_sample_offsets(n_tokens, seq_len, _i64ptr(out), max_out)
    return out[:n]
