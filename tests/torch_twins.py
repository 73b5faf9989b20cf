"""The JAX package's own tests, run on both packages.

``twin_tests("test_vault_depth")`` loads tests/test_vault_depth.py twice:
once as written, and once with every ``neumann_tpu`` in its source
replaced by ``neumann_tpu_torch`` (and ``QueryRouter()`` by the port's
CPU router). For each of the file's tests it returns one test, of the
same name, parametrised over ``package`` ("jax", "port"): the same
scenario on the reference and on the port's copy of the modules it
covers. The file's own fixtures are resolved per package; pytest's
(``tmp_path``, ``monkeypatch``, ...) and its parametrisations carry over.
A test module assigns the returned tests to its globals to have pytest
collect them.
"""

from __future__ import annotations

import contextlib
import inspect
import re
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("jax", "port")


def _load(name: str, package: str) -> types.ModuleType:
    path = TESTS / f"{name}.py"
    src = path.read_text()
    if package == "port":
        src = re.sub(r"\bneumann_tpu\b", "neumann_tpu_torch", src)
        src = src.replace("QueryRouter()", 'QueryRouter(device="cpu")')
    mod = types.ModuleType(f"_twin_{package}_{name}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _fixture(obj):
    """The function under a module-level ``@pytest.fixture``, or None."""
    unwrap = getattr(obj, "_get_wrapped_function", None)
    return unwrap() if unwrap is not None else None


def _fixture_value(mod, name: str, request, stack):
    fn = _fixture(getattr(mod, name))
    kw = {arg: (_fixture_value(mod, arg, request, stack)
                if _fixture(getattr(mod, arg, None)) else
                request.getfixturevalue(arg))
          for arg in inspect.signature(fn).parameters}
    value = fn(**kw)
    if inspect.isgenerator(value):
        gen, value = value, next(value)
        stack.callback(next, gen, None)
    return value


def _twin(name: str, mods: dict):
    jf = getattr(mods["jax"], name)
    sig = inspect.signature(jf)
    local = {p for p in sig.parameters
             if _fixture(getattr(mods["jax"], p, None)) is not None}
    outer = [p for p in sig.parameters.values() if p.name not in local]
    if "request" not in sig.parameters:
        outer.append(inspect.Parameter(
            "request", inspect.Parameter.POSITIONAL_OR_KEYWORD))

    def test(package, request, **kw):
        mod = mods[package]
        if "request" in sig.parameters:
            kw["request"] = request
        with contextlib.ExitStack() as stack:
            for fx in local:
                kw[fx] = _fixture_value(mod, fx, request, stack)
            getattr(mod, name)(**kw)

    test.__name__ = test.__qualname__ = name
    test.__doc__ = jf.__doc__
    test.__signature__ = inspect.Signature([inspect.Parameter(
        "package", inspect.Parameter.POSITIONAL_OR_KEYWORD), *outer])
    test.pytestmark = [*getattr(jf, "pytestmark", []),
                       pytest.mark.parametrize("package", PACKAGES)]
    return test


def twin_tests(module: str, names=None) -> dict:
    """{test name: twin test} for the tests of tests/<module>.py (all of
    them, or those whose names ``names`` lists)."""
    mods = {pkg: _load(module, pkg) for pkg in PACKAGES}
    found = [n for n, obj in vars(mods["jax"]).items()
             if n.startswith("test_") and inspect.isfunction(obj)]
    if names is not None:
        missing = set(names) - set(found)
        assert not missing, f"{module} has no {sorted(missing)}"
        found = [n for n in found if n in names]
    return {n: _twin(n, mods) for n in found}
