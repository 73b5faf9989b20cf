"""Loader for the native fast-path parser (_neumann_parser).

The port's copy of ``neumann_tpu/native/pyparser.py``. Compiles this
directory's ``parser_ext.cpp`` at first use into
``build/neumann_tpu_torch/`` (``native.build_shared``, hash-named, never
beside the source) and registers the port's ``lang.ast`` dataclasses and
``engines.condition.Condition`` (slot layouts) with it. Returns None
when no toolchain is available or the classes stop being slots
dataclasses — lang.parser then runs pure-Python for everything.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "parser_ext.cpp"

_lock = threading.Lock()
_mod = None
_tried = False


def _specs():
    from neumann_tpu_torch.engines.condition import Condition
    from neumann_tpu_torch.lang import ast

    def fields(cls):
        import dataclasses

        return tuple(f.name for f in dataclasses.fields(cls))

    return tuple(
        (name, cls, fields(cls))
        for name, cls in (
            ("Select", ast.Select),
            ("SelectItem", ast.SelectItem),
            ("Insert", ast.Insert),
            ("Similar", ast.Similar),
            ("Condition", Condition),
            ("NodeCreate", ast.NodeCreate),
            ("Find", ast.Find),
            ("Update", ast.Update),
            ("Delete", ast.Delete),
            ("EmbedStore", ast.EmbedStore),
            ("EmbedGet", ast.EmbedGet),
            ("EmbedDelete", ast.EmbedDelete),
        ))


def _build_args():
    inc = sysconfig.get_paths()["include"]
    return (_SRC, "_neumann_parser",
            sysconfig.get_config_var("EXT_SUFFIX") or ".so",
            ("-O3", "-shared", "-fPIC", f"-I{inc}"))


def load():
    """Build (if missing), import, and initialise the extension."""
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
                "_neumann_parser", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if not mod.init_parser(_specs()):
                return None          # AST classes not slot dataclasses
        except (OSError, subprocess.SubprocessError, ImportError):
            return None
        _mod = mod
        return _mod


def available() -> bool:
    return load() is not None


def built() -> bool:
    """True when the extension is already compiled for this source —
    i.e. load() would be a plain import, no g++ subprocess."""
    from neumann_tpu_torch.native import built_path

    try:
        return built_path(*_build_args(), salt=sys.version).exists()
    except OSError:
        return False
