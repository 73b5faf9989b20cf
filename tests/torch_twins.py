"""The JAX package's own tests, run on both packages.

``twin_tests("test_vault_depth")`` loads tests/test_vault_depth.py twice:
once as written, and once with every ``neumann_tpu`` in its source
replaced by ``neumann_tpu_torch``, and the port's entry points that run
on the card by default asked for the CPU (``QueryRouter()``,
``VectorEngine``, the chain's ``TcpClusterNode`` / ``build_node`` /
``classify_pairwise(_codes)``, the server's ``NeumannServer`` /
``RestServer`` / ``NeumannClient.embedded`` / ``main``, the graph
engines ``GraphEngine`` / ``DistributedGraphEngine``, the
``SemanticPartitioner``, ``make_mesh``, and ``python -m
neumann_tpu_torch.chain.node`` or ``neumann_tpu_torch.server``, whose
processes import this checkout); helpers it imports from another test
file come from that file's port twin. For each of the file's tests (a
test class's methods too) it returns one test, of the same name,
parametrised over ``package`` ("jax", "port", or those that ``packages``
names): the same scenario on the reference and on the port's copy of
the modules it covers. The file's own fixtures are resolved per package
and per test, a module-scoped one once a module; pytest's
(``tmp_path``, ``monkeypatch``, ...) and its parametrisations carry
over.
A test module assigns the returned tests to its globals to have pytest
collect them.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("jax", "port")
# the port's entry points with a device argument that defaults to "cuda"
_ON_CARD = r"\b(TcpClusterNode|build_node|classify_pairwise_codes|" \
    r"classify_pairwise|NeumannServer|RestServer|NeumannClient\.embedded|" \
    r"srvmod\.main|VectorEngine|SemanticPartitioner|DistributedGraphEngine|" \
    r"GraphEngine|make_mesh)\("


def _on_cpu(fn):
    """``fn``, a port entry point of ``_ON_CARD``, asked for the CPU."""
    if fn.__name__ in ("build_node", "main"):
        return lambda argv: fn([*argv, "--device", "cpu"])
    return functools.partial(fn, device="cpu")


def _load(name: str, package: str, absent=(), patch=None, port_patch=None
          ) -> types.ModuleType:
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in (patch or {}).items():
        assert old in src, f"{name} has no {old!r}"
        src = src.replace(old, new)
    for module in absent:
        # a one-line import of a module the port lacks binds None, so the
        # file's other tests load; tests of that module are not twinned
        src = re.sub(rf"^from {re.escape(module)} import (\w+)$",
                     r"\1 = None", src, flags=re.M)
    mod = types.ModuleType(f"_twin_{package}_{name}")
    if package == "port":
        # helpers imported from another JAX test file come from its twin
        for dep in sorted(set(re.findall(r"^from tests\.(test_\w+) import",
                                         src, re.M))):
            if f"_twin_port_{dep}" not in sys.modules:
                sys.modules[f"_twin_port_{dep}"] = _load(dep, "port")
        src = re.sub(r"^from tests\.(test_\w+) import",
                     r"from _twin_port_\1 import", src, flags=re.M)
        src = re.sub(r"\bneumann_tpu\b", "neumann_tpu_torch", src)
        src = src.replace("QueryRouter()", 'QueryRouter(device="cpu")')
        src = re.sub(_ON_CARD, r"_cpu(\1)(", src)
        src = re.sub(r'("-m", "neumann_tpu_torch\.(?:chain\.node|server)",)',
                     r'\1 "--device", "cpu",', src)
        src = re.sub(r'(env\["PYTHONPATH"\] = )"[^"]*"',
                     lambda m: m.group(1) + repr(str(TESTS.parent)), src)
        for old, new in (port_patch or {}).items():
            assert old in src, f"{name}'s port twin has no {old!r}"
            src = src.replace(old, new)
        mod._cpu = _on_cpu
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _fixture(obj):
    """The function under a module-level ``@pytest.fixture``, or None."""
    unwrap = getattr(obj, "_get_wrapped_function", None)
    return unwrap() if unwrap is not None else None


def _fixture_value(mod, name: str, request, stack, cache):
    """The value of the file's fixture ``name`` in this test: made once
    a test (``cache``), or once a module for a module-scoped fixture,
    which the test module's teardown then ends."""
    obj = getattr(mod, name)
    if obj._fixture_function_marker.scope != "function":
        values = mod.__dict__.setdefault("_twin_module_fixtures", {})
        if name not in values:
            module_stack = contextlib.ExitStack()
            values[name] = _make_fixture(mod, name, request, module_stack,
                                         {})
            request.node.getparent(pytest.Module).addfinalizer(
                lambda: (values.pop(name, None), module_stack.close()))
        return values[name]
    if name not in cache:
        cache[name] = _make_fixture(mod, name, request, stack, cache)
    return cache[name]


def _make_fixture(mod, name: str, request, stack, cache):
    fn = _fixture(getattr(mod, name))
    kw = {arg: (_fixture_value(mod, arg, request, stack, cache)
                if _fixture(getattr(mod, arg, None)) else
                request.getfixturevalue(arg))
          for arg in inspect.signature(fn).parameters}
    value = fn(**kw)
    if inspect.isgenerator(value):
        gen, value = value, next(value)
        stack.callback(next, gen, None)
    return value


def _target(mod, name: str):
    """The test ``name`` of a loaded module: a function, or for
    ``"TestClass.test_method"`` the method bound to a new instance."""
    cls, _, meth = name.rpartition(".")
    return getattr(getattr(mod, cls)(), meth) if cls else getattr(mod, name)


def _twin(name: str, mods: dict):
    first = next(iter(mods.values()))
    jf = _target(first, name)
    sig = inspect.signature(jf)
    local = {p for p in sig.parameters
             if _fixture(getattr(first, p, None)) is not None}
    # a parameter with a default is no fixture: the test's default holds
    outer = [p for p in sig.parameters.values()
             if p.name not in local and p.default is p.empty]
    if "request" not in sig.parameters:
        outer.append(inspect.Parameter(
            "request", inspect.Parameter.POSITIONAL_OR_KEYWORD))

    def test(package, request, **kw):
        mod = mods[package]
        if "request" in sig.parameters:
            kw["request"] = request
        with contextlib.ExitStack() as stack:
            cache = {}
            for fx in local:
                kw[fx] = _fixture_value(mod, fx, request, stack, cache)
            _target(mod, name)(**kw)

    params = [inspect.Parameter(
        "package", inspect.Parameter.POSITIONAL_OR_KEYWORD), *outer]
    if "." in name:        # a method of the test class that holds it
        method = test

        def test(self, package, request, **kw):
            method(package, request, **kw)

        params.insert(0, inspect.Parameter(
            "self", inspect.Parameter.POSITIONAL_OR_KEYWORD))
    test.__name__ = test.__qualname__ = name.rpartition(".")[2]
    test.__doc__ = jf.__doc__
    test.__signature__ = inspect.Signature(params)
    test.pytestmark = [*getattr(jf, "pytestmark", []),
                       pytest.mark.parametrize("package", tuple(mods))]
    return test


def twin_tests(module: str, names=None, packages=PACKAGES,
               absent=(), patch=None, port_patch=None) -> dict:
    """{test name: twin test} for the tests of tests/<module>.py (all of
    them, or those whose names ``names`` lists), on each of ``packages``
    (("port",) where the JAX side already runs in its own file). A test
    method is named ``"TestClass.test_method"``; the twins of a class's
    methods come back as a class of that name. ``absent`` names modules
    of the JAX package that the port does not have yet: the file's
    one-line imports of them bind None. ``patch`` ({old: new}) replaces
    text of the file's source on every package (each ``old`` must occur):
    a test's setting changed for both twins, said where it is used.
    ``port_patch`` ({old: new}) replaces text of the port twin's source
    after its rewrites above (``neumann_tpu_torch``, ``_cpu(...)``): for
    a line the rewrites cannot carry, such as a worker script's JAX
    backend query, said where it is used."""
    mods = {pkg: _load(module, pkg, absent, patch, port_patch)
            for pkg in packages}
    found = []
    for n, obj in vars(next(iter(mods.values()))).items():
        if n.startswith("test_") and inspect.isfunction(obj):
            found.append(n)
        elif n.startswith("Test") and inspect.isclass(obj):
            found += [f"{n}.{m}" for m, f in vars(obj).items()
                      if m.startswith("test_") and inspect.isfunction(f)]
    if names is not None:
        missing = set(names) - set(found)
        assert not missing, f"{module} has no {sorted(missing)}"
        found = [n for n in found if n in names]
    out = {}
    for n in found:
        cls, _, meth = n.rpartition(".")
        if cls:
            out.setdefault(cls, type(cls, (), {}))
            setattr(out[cls], meth, _twin(n, mods))
        else:
            out[n] = _twin(n, mods)
    return out
