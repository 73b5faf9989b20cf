"""Loader for the native tokenizer extension (_neumann_lexer).

The port's copy of ``neumann_tpu/native/pylexer.py``. Compiles this
directory's ``lexer_ext.cpp`` against the running interpreter's headers
at first use, into ``build/neumann_tpu_torch/`` (``native.build_shared``,
hash-named, never beside the source), and initialises it with the
port's ``lang.lexer.Token``. Returns None when no toolchain is available
(the regex lexer in lang/lexer.py remains the fallback and the
specification).
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "lexer_ext.cpp"

_lock = threading.Lock()
_mod = None
_tried = False


def load():
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
                _SRC, "_neumann_lexer",
                sysconfig.get_config_var("EXT_SUFFIX") or ".so",
                ("-O3", "-shared", "-fPIC", f"-I{inc}"), salt=sys.version)
            spec = importlib.util.spec_from_file_location(
                "_neumann_lexer", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (OSError, subprocess.SubprocessError, ImportError):
            return None
        from neumann_tpu_torch.lang.lexer import Token

        mod.init(Token)
        _mod = mod
        return _mod


def available() -> bool:
    return load() is not None
