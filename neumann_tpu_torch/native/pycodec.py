"""Loader for the native codec extension (_neumann_codec).

The port's copy of ``neumann_tpu/native/pycodec.py``. Compiles this
directory's ``codec_ext.cpp`` against the running interpreter's headers
at first use, into ``build/neumann_tpu_torch/`` (``native.build_shared``),
and initialises it with the port's TensorValue/TensorData classes plus
numpy helpers. The library file is the port's own, so the interpreter
loads a separate image with its own module state even when the JAX
package's codec is loaded too. Returns None when no toolchain is
available — the pure-Python codec in store/codec.py remains the fallback
and both implementations share the exact on-disk byte format.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec_ext.cpp"

_lock = threading.Lock()
_mod = None
_tried = False


def _vec_from_bytes(b):
    return np.frombuffer(b, "<f4").copy()


def _sparse_cls():
    from neumann_tpu_torch.store.sparse import SparseVector

    return SparseVector


def _as_f4_bytes(v):
    return np.asarray(v, "<f4").tobytes()


def _sparse_parts(sv):
    return (sv.dim, np.asarray(sv.positions, "<i4").tobytes(),
            np.asarray(sv.values, "<f4").tobytes())


def load():
    """Build (if stale), import, and initialise the extension.

    Returns the module, or None when compilation fails (no g++, no
    headers): callers fall back to the pure-Python codec.
    """
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    with _lock:
        if _mod is not None or _tried:
            return _mod
        _tried = True
        try:
            from neumann_tpu_torch.native import build_shared

            inc = sysconfig.get_paths()["include"]
            so = build_shared(
                _SRC, "_neumann_codec",
                sysconfig.get_config_var("EXT_SUFFIX") or ".so",
                ("-O3", "-shared", "-fPIC", f"-I{inc}",
                 f"-I{np.get_include()}"), ("-lz",),
                salt=f"{sys.version} numpy {np.__version__}")
            spec = importlib.util.spec_from_file_location(
                "_neumann_codec", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (OSError, subprocess.SubprocessError, ImportError):
            return None
        from neumann_tpu_torch.store.tensor_store import (
            TensorData,
            TensorValue,
        )

        mod.init(TensorValue, TensorData, _vec_from_bytes,
                 _sparse_cls(), _as_f4_bytes, _sparse_parts)
        _mod = mod
        return _mod


def available() -> bool:
    return load() is not None
