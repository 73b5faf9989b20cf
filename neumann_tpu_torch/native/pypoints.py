"""Loader for the native PointsService proto codec (_neumann_points).

The port's copy of ``neumann_tpu/native/pypoints.py``. Compiles this
directory's ``points_ext.cpp`` against the running interpreter's headers
at first use into ``build/neumann_tpu_torch/`` (``native.build_shared``,
hash-named, renamed into place, never beside the source). Returns None
when no toolchain is available — the server and client fall back to the
Python protobuf classes (same wire bytes, slower marshaling).
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "points_ext.cpp"

_lock = threading.Lock()
_mod = None
_tried = False


def _build_args():
    inc = sysconfig.get_paths()["include"]
    return (_SRC, "_neumann_points",
            sysconfig.get_config_var("EXT_SUFFIX") or ".so",
            ("-O3", "-shared", "-fPIC", f"-I{inc}"))


def load():
    """Build (if missing), import, and return the extension; None when
    compilation fails (no g++ / headers)."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    with _lock:
        if _mod is not None or _tried:
            return _mod
        _tried = True
        try:
            from neumann_tpu_torch.native import build_shared

            so = build_shared(*_build_args(), salt=sys.version)
            spec = importlib.util.spec_from_file_location(
                "_neumann_points", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (OSError, subprocess.SubprocessError, ImportError):
            return None
        _mod = mod
        return _mod


def available() -> bool:
    return load() is not None
