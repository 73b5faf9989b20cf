"""ctypes loader for the C++ native module.

The port's copy of ``neumann_tpu/native/__init__.py``. Compiles
``neumann_native.cpp`` and ``hnsw_native.cpp`` (this directory's copies)
into one library with g++ at first use into
``build/neumann_tpu_torch/`` at the root of the checkout, never beside
the source: the library's name carries a hash of the sources, and each
build writes a file of its own and renames it into place, so concurrent
first uses never load a half-written library. Returns None if no
compiler is available, in which case callers use the pure-Python
implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRCS = tuple(Path(__file__).resolve().parent / name
              for name in ("neumann_native.cpp", "hnsw_native.cpp"))
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "neumann_tpu_torch")
_FLAGS = ("-O3", "-fno-math-errno", "-shared", "-fPIC")


def _sources(src) -> tuple:
    return (src,) if isinstance(src, Path) else tuple(src)


def built_path(src, stem: str, suffix: str, flags,
               salt: str = "") -> Path:
    """``BUILD_DIR/<stem>-<hash><suffix>``: where ``build_shared`` puts
    ``src`` (a source, or several built into one library). The hash
    covers the sources, the flags and ``salt`` (what else the build
    depends on)."""
    tag = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(src))
                         + " ".join(flags).encode()
                         + salt.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{tag}{suffix}"


def build_shared(src, stem: str, suffix: str, flags, libs=(),
                 salt: str = "") -> Path:
    """Compile ``src`` with g++ into ``built_path(...)`` unless that file
    exists, and return its path. The output is written under a
    per-process name and renamed into place."""
    out = built_path(src, stem, suffix, flags, salt)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *flags, *map(str, _sources(src)), *libs,
                            "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


_lock = threading.Lock()
_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """Return the native library, building it if needed; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_shared(
                _SRCS, "libneumann_native", ".so", _FLAGS)))
        except (OSError, subprocess.SubprocessError):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.nn_crc32.restype = ctypes.c_uint32
        lib.nn_crc32.argtypes = [u8p, ctypes.c_size_t]
        lib.nn_wal_frame.restype = ctypes.c_size_t
        lib.nn_wal_frame.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.nn_wal_scan.restype = ctypes.c_size_t
        lib.nn_wal_scan.argtypes = [u8p, ctypes.c_size_t, u64p,
                                    ctypes.c_size_t]
        lib.nn_varint_encode.restype = ctypes.c_size_t
        lib.nn_varint_encode.argtypes = [u64p, ctypes.c_size_t, u8p]
        lib.nn_varint_decode.restype = ctypes.c_size_t
        lib.nn_varint_decode.argtypes = [u8p, ctypes.c_size_t, u64p,
                                         ctypes.c_size_t]
        lib.nn_delta_encode_ids.restype = ctypes.c_size_t
        lib.nn_delta_encode_ids.argtypes = [u64p, ctypes.c_size_t, u8p]
        lib.nn_delta_decode_ids.restype = ctypes.c_size_t
        lib.nn_delta_decode_ids.argtypes = [u8p, ctypes.c_size_t, u64p,
                                            ctypes.c_size_t]
        lib.nn_rle_encode.restype = ctypes.c_size_t
        lib.nn_rle_encode.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.nn_rle_decode.restype = ctypes.c_size_t
        lib.nn_rle_decode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                      ctypes.c_size_t]
        f32p = ctypes.POINTER(ctypes.c_float)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.nn_quantize_int8.restype = None
        lib.nn_quantize_int8.argtypes = [f32p, ctypes.c_size_t,
                                         ctypes.c_size_t, i8p, f32p,
                                         i8p, f32p]
        cp = ctypes.c_char_p
        lib.nn_oki_new.restype = ctypes.c_void_p
        lib.nn_oki_new.argtypes = []
        lib.nn_oki_free.restype = None
        lib.nn_oki_free.argtypes = [ctypes.c_void_p]
        lib.nn_oki_insert.restype = ctypes.c_int
        lib.nn_oki_insert.argtypes = [ctypes.c_void_p, cp,
                                      ctypes.c_size_t]
        lib.nn_oki_insert_batch.restype = ctypes.c_size_t
        lib.nn_oki_insert_batch.argtypes = [
            ctypes.c_void_p, cp, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t]
        lib.nn_oki_remove.restype = ctypes.c_int
        lib.nn_oki_remove.argtypes = [ctypes.c_void_p, cp,
                                      ctypes.c_size_t]
        lib.nn_oki_len.restype = ctypes.c_size_t
        lib.nn_oki_len.argtypes = [ctypes.c_void_p]
        lib.nn_oki_count_prefix.restype = ctypes.c_size_t
        lib.nn_oki_count_prefix.argtypes = [ctypes.c_void_p, cp,
                                            ctypes.c_size_t]
        lib.nn_oki_scan_prefix.restype = ctypes.c_size_t
        lib.nn_oki_scan_prefix.argtypes = [ctypes.c_void_p, cp,
                                           ctypes.c_size_t, cp,
                                           ctypes.c_size_t]
        lib.nn_oki_scan_range.restype = ctypes.c_size_t
        lib.nn_oki_scan_range.argtypes = [ctypes.c_void_p, cp,
                                          ctypes.c_size_t, cp,
                                          ctypes.c_size_t, ctypes.c_int,
                                          cp, ctypes.c_size_t]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        vp = ctypes.c_void_p
        lib.nn_hnsw_new.restype = vp
        lib.nn_hnsw_new.argtypes = [ctypes.c_int] * 5 + [
            ctypes.c_uint64, ctypes.c_uint64]
        lib.nn_hnsw_free.restype = None
        lib.nn_hnsw_free.argtypes = [vp]
        lib.nn_hnsw_len.restype = ctypes.c_size_t
        lib.nn_hnsw_len.argtypes = [vp]
        for name in ("nn_hnsw_insert", "nn_hnsw_insert_quantized",
                     "nn_hnsw_insert_binary"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [vp, f32p]
        lib.nn_hnsw_insert_sparse.restype = ctypes.c_int64
        lib.nn_hnsw_insert_sparse.argtypes = [vp, u32p, f32p,
                                              ctypes.c_uint32]
        lib.nn_hnsw_kind.restype = ctypes.c_int
        lib.nn_hnsw_kind.argtypes = [vp, ctypes.c_int64]
        lib.nn_hnsw_get.restype = ctypes.c_int
        lib.nn_hnsw_get.argtypes = [vp, ctypes.c_int64, f32p]
        lib.nn_hnsw_memory_bytes.restype = ctypes.c_uint64
        lib.nn_hnsw_memory_bytes.argtypes = [vp]
        lib.nn_hnsw_search.restype = ctypes.c_size_t
        lib.nn_hnsw_search.argtypes = [vp, f32p, ctypes.c_size_t,
                                       ctypes.c_size_t, i64p, f32p]
        lib.nn_hnsw_stats.restype = None
        lib.nn_hnsw_stats.argtypes = [vp, u64p]
        lib.nn_hnsw_serialize.restype = ctypes.c_size_t
        lib.nn_hnsw_serialize.argtypes = [vp, u8p, ctypes.c_size_t]
        lib.nn_hnsw_deserialize.restype = vp
        lib.nn_hnsw_deserialize.argtypes = [u8p, ctypes.c_size_t]
        _lib = lib
        return _lib


def _as_u8(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf),
                       ctypes.POINTER(ctypes.c_uint8))


# -- python-facing helpers (None-safe: callers check available()) ---------

def available() -> bool:
    return load() is not None


def crc32(buf: bytes) -> int:
    lib = load()
    return lib.nn_crc32(_as_u8(buf), len(buf))


def wal_scan(buf: bytes, max_records: int = 1 << 20):
    """[(offset, length)] of valid records, stopping at corruption."""
    lib = load()
    out = (ctypes.c_uint64 * (2 * max_records))()
    n = lib.nn_wal_scan(_as_u8(buf), len(buf), out, max_records)
    return [(out[2 * i], out[2 * i + 1]) for i in range(n)]


def wal_frame(payload: bytes) -> bytes:
    lib = load()
    out = (ctypes.c_uint8 * (len(payload) + 8))()
    n = lib.nn_wal_frame(_as_u8(payload), len(payload), out)
    return bytes(out[:n])


def varint_encode(values) -> bytes:
    lib = load()
    n = len(values)
    arr = (ctypes.c_uint64 * n)(*values)
    out = (ctypes.c_uint8 * (10 * n))()
    size = lib.nn_varint_encode(arr, n, out)
    return bytes(out[:size])


def varint_decode(buf: bytes, max_n: int = 1 << 22):
    lib = load()
    out = (ctypes.c_uint64 * max_n)()
    n = lib.nn_varint_decode(_as_u8(buf), len(buf), out, max_n)
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("truncated varint stream")
    return [out[i] for i in range(n)]


def delta_encode_ids(ids) -> bytes:
    lib = load()
    n = len(ids)
    arr = (ctypes.c_uint64 * n)(*ids)
    out = (ctypes.c_uint8 * (10 * max(n, 1)))()
    size = lib.nn_delta_encode_ids(arr, n, out)
    return bytes(out[:size])


def delta_decode_ids(buf: bytes, max_n: int = 1 << 22):
    lib = load()
    out = (ctypes.c_uint64 * max_n)()
    n = lib.nn_delta_decode_ids(_as_u8(buf), len(buf), out, max_n)
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("truncated varint stream")
    return [out[i] for i in range(n)]


def rle_encode(data: bytes) -> bytes:
    lib = load()
    out = (ctypes.c_uint8 * (2 * max(len(data), 1)))()
    n = lib.nn_rle_encode(_as_u8(data), len(data), out)
    return bytes(out[:n])


def rle_decode(buf: bytes, max_out: Optional[int] = None) -> bytes:
    lib = load()
    cap = max_out if max_out is not None else 255 * (len(buf) // 2) + 1
    out = (ctypes.c_uint8 * cap)()
    n = lib.nn_rle_decode(_as_u8(buf), len(buf), out, cap)
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("truncated RLE stream")
    return bytes(out[:n])


def quantize_int8(x, q, scale, rq=None, rscale=None) -> bool:
    """Single-pass per-row symmetric int8 quantization into caller
    buffers (numpy: x [n,d] f32 C-contig, q [n,d] int8, scale [n] f32,
    optional residual plane rq/rscale). Returns False when the native
    library is unavailable (caller falls back to numpy)."""
    lib = load()
    if lib is None:
        return False
    import ctypes as _ct

    import numpy as _np

    assert x.dtype == _np.float32 and x.flags.c_contiguous
    n, d = x.shape
    f32p = _ct.POINTER(_ct.c_float)
    i8p = _ct.POINTER(_ct.c_int8)
    lib.nn_quantize_int8(
        x.ctypes.data_as(f32p), n, d,
        q.ctypes.data_as(i8p), scale.ctypes.data_as(f32p),
        rq.ctypes.data_as(i8p) if rq is not None else None,
        rscale.ctypes.data_as(f32p) if rscale is not None else None)
    return True
