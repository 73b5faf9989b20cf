"""The JAX package's own tests, run on both packages.

``twin_tests("test_vault_depth")`` loads tests/test_vault_depth.py twice:
once as written, and once with every ``neumann_tpu`` in its source
replaced by ``neumann_tpu_torch``, and the port's entry points that run
on the card by default asked for the CPU (``QueryRouter()``,
``VectorEngine``, the chain's ``TcpClusterNode`` / ``build_node`` /
``classify_pairwise(_codes)``, the server's ``NeumannServer`` /
``RestServer`` / ``NeumannClient.embedded`` / ``main``, the graph
engines ``GraphEngine`` / ``DistributedGraphEngine``, the
``SemanticPartitioner``, ``make_mesh``, ``EmbeddingSlab``, the indexes
``IVFIndex`` / ``DeviceIVFInt8`` / ``PQCodebook``, the chain's
``CodebookManager`` / ``GlobalCodebook`` / ``ArchetypeRegistry``,
``UnifiedEngine`` (whose own ``VectorEngine`` goes on the CPU), the
``Shell`` (over a CPU ``QueryRouter``), and
``python -m
neumann_tpu_torch.chain.node`` or ``neumann_tpu_torch.server``, whose
processes import this checkout); helpers it imports from another test
file come from that file's port twin. The functions it imports from
``neumann_tpu_torch.ops`` take numpy arguments as CPU tensors, as the
JAX functions take them as arrays; with ``torch_jnp`` its ``jax.numpy``
makes CPU tensors too (``_TorchNumpy``: ``jax.jit`` is the function
itself, ``.astype(jnp.<type>)`` becomes ``.to(...)``), for a file that
builds the inputs of ``ops/`` with it. For each of the file's tests (a
test class's methods too) it returns one test, of the same name,
parametrised over ``package`` ("jax", "port", or those that ``packages``
names): the same scenario on the reference and on the port's copy of
the modules it covers. The file's own fixtures are resolved per package
and per test, a module-scoped one once a module; pytest's
(``tmp_path``, ``monkeypatch``, ...) and its parametrisations carry
over, a parametrised fixture's ``params`` too (one twin per param).
A test module assigns the returned tests to its globals to have pytest
collect them.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
PACKAGES = ("jax", "port")
# the port's entry points with a device argument that defaults to "cuda"
_ON_CARD = r"\b(TcpClusterNode|build_node|classify_pairwise_codes|" \
    r"classify_pairwise|NeumannServer|RestServer|NeumannClient\.embedded|" \
    r"srvmod\.main|VectorEngine|SemanticPartitioner|DistributedGraphEngine|" \
    r"GraphEngine|make_mesh|EmbeddingSlab|CodebookManager|GlobalCodebook|" \
    r"ArchetypeRegistry|IVFIndex|DeviceIVFInt8|PQCodebook)\("


def _on_cpu(fn):
    """``fn``, a port entry point of ``_ON_CARD``, asked for the CPU."""
    if fn.__name__ in ("build_node", "main"):
        return lambda argv: fn([*argv, "--device", "cpu"])
    if fn.__name__ == "UnifiedEngine":
        return _unified_on_cpu(fn)
    if fn.__name__ == "Shell":
        return _shell_on_cpu(fn)
    return functools.partial(fn, device="cpu")


def _shell_on_cpu(cls):
    """``Shell`` over a CPU ``QueryRouter`` when the caller gives none."""
    from neumann_tpu_torch.router import QueryRouter

    def make(*a, router=None, **kw):
        return cls(*a, router=router or QueryRouter(device="cpu"), **kw)
    return make


def _unified_on_cpu(cls):
    """``UnifiedEngine`` whose own ``VectorEngine`` (when the caller
    gives none) is on the CPU."""
    from neumann_tpu_torch.engines.vector import VectorEngine
    from neumann_tpu_torch.store.tensor_store import TensorStore

    def make(store=None, relational=None, graph=None, vector=None):
        store = store if store is not None else TensorStore()
        if vector is None:
            vector = VectorEngine(store, device="cpu")
        return cls(store, relational, graph, vector)
    return make


def _tensor(a, dtype=None):
    """A CPU tensor of ``a`` as ``jnp.asarray`` makes an array: numpy
    float64 / int64 become float32 / int32 (JAX's default precision)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif dtype is None and arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(_dtype(dtype))


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class _TorchNumpy:
    """The ``jax.numpy`` calls the JAX package's op tests make, on CPU
    tensors (the ``jnp`` of their port twins)."""
    float32, int32 = torch.float32, torch.int32

    asarray = staticmethod(_tensor)

    @staticmethod
    def arange(*a, dtype=None):
        return torch.arange(*a, dtype=None if dtype is None
                            else _dtype(dtype))

    @staticmethod
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=_dtype(dtype))

    @staticmethod
    def concatenate(arrays, axis=0):
        return torch.cat([_tensor(a) for a in arrays], dim=axis)

    @staticmethod
    def max(a, axis=None):
        a = _tensor(a)
        return a.max() if axis is None else a.amax(dim=axis)

    @staticmethod
    def min(a, axis=None):
        a = _tensor(a)
        return a.min() if axis is None else a.amin(dim=axis)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(_tensor(a), torch.as_tensor(b))

    @staticmethod
    def sort(a, axis=-1):
        return torch.sort(_tensor(a), dim=axis).values

    @staticmethod
    def allclose(a, b, **kw):
        return torch.allclose(_tensor(a), _tensor(b), **kw)

    class linalg:
        @staticmethod
        def norm(a, axis=None, keepdims=False):
            return torch.linalg.norm(_tensor(a), dim=axis, keepdim=keepdims)


class _TorchJax:
    """``jax`` in a port twin: ``jax.jit(f, ...)`` is ``f``."""
    numpy = _TorchNumpy

    @staticmethod
    def jit(fn, **_):
        return fn


def _numpy_in(fn):
    """``fn``, an ``ops/`` function of the port, with numpy arguments
    handed over as CPU tensors (``_tensor``)."""
    if not callable(fn) or isinstance(fn, type):
        return fn

    @functools.wraps(fn)
    def call(*a, **kw):
        conv = (lambda v: _tensor(v) if isinstance(v, np.ndarray) else v)
        return fn(*map(conv, a), **{k: conv(v) for k, v in kw.items()})
    return call


def _ops_import(module: str, *names: str):
    """The names ``from <module> import ...`` binds, through
    ``_numpy_in``; a JAX ``<f>_jit`` (``jax.jit`` of ``<f>``) is the
    port's ``<f>``, which has no jitted twin."""
    mod = importlib.import_module(module)
    out = tuple(_numpy_in(getattr(mod, n) if hasattr(mod, n) or
                          not n.endswith("_jit") else getattr(mod, n[:-4]))
                for n in names)
    return out if len(out) > 1 else out[0]


def _rewrite_ops_imports(src: str) -> str:
    """``from neumann_tpu_torch.ops[.x] import a, b as c`` (one line or
    parenthesised) -> ``a, c = _ops_import("...", "a", "b")``."""
    def sub(m):
        indent, module, body = m.group(1), m.group(2), m.group(3)
        pairs = [p.split(" as ") for p in
                 (x.strip() for x in body.strip("()").replace("\n", " ")
                  .split(",")) if p]
        names = [p[0].strip() for p in pairs]
        binds = [p[-1].strip() for p in pairs]
        args = ", ".join(repr(n) for n in names)
        return f"{indent}{', '.join(binds)} = _ops_import({module!r}, {args})"
    return re.sub(
        r"^([ \t]*)from (neumann_tpu_torch\.ops(?:\.\w+)?) import "
        r"(\([^)]*\)|[^\n(]+?)(?:[ \t]*#[^\n]*)?$",
        sub, src, flags=re.M)


def _load(name: str, package: str, absent=(), patch=None, port_patch=None,
          torch_jnp=False) -> types.ModuleType:
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
        src = re.sub(r"\b(UnifiedEngine|Shell)\(", r"_cpu(\1)(", src)
        if torch_jnp:
            src = re.sub(r"^([ \t]*)import jax\.numpy as jnp$",
                         r"\1jnp = _jnp", src, flags=re.M)
            src = re.sub(r"^([ \t]*)import jax$", r"\1jax = _jax", src,
                         flags=re.M)
            src = src.replace(".astype(jnp.", ".to(jnp.")
        src = _rewrite_ops_imports(src)
        for old, new in (port_patch or {}).items():
            assert old in src, f"{name}'s port twin has no {old!r}"
            src = src.replace(old, new)
        mod._cpu = _on_cpu
        mod._jnp, mod._jax, mod._ops_import = _TorchNumpy, _TorchJax, \
            _ops_import
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_NO_PARAM = object()


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


class _ParamRequest:
    """``request`` as a parametrised fixture sees it: ``param`` is this
    twin's value of the fixture's ``params``."""

    def __init__(self, request, param):
        self._request, self.param = request, param

    def __getattr__(self, name):
        return getattr(self._request, name)


def _params_arg(name: str) -> str:
    return f"_twin_param_{name}"


def _make_fixture(mod, name: str, request, stack, cache):
    fn = _fixture(getattr(mod, name))
    kw = {arg: (_fixture_value(mod, arg, request, stack, cache)
                if _fixture(getattr(mod, arg, None)) else
                request.getfixturevalue(arg))
          for arg in inspect.signature(fn).parameters if arg != "request"}
    if "request" in inspect.signature(fn).parameters:
        params = cache.get(("params", name), _NO_PARAM)
        kw["request"] = (request if params is _NO_PARAM
                         else _ParamRequest(request, params))
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


def _fixture_params(mod, names) -> dict:
    """{fixture: (params, ids)} of the parametrised fixtures among
    ``names`` and the file's fixtures they use."""
    out, todo = {}, list(names)
    while todo:
        name = todo.pop()
        fn = _fixture(getattr(mod, name, None))
        if fn is None or name in out:
            continue
        marker = getattr(mod, name)._fixture_function_marker
        out[name] = (marker.params, marker.ids)
        todo += list(inspect.signature(fn).parameters)
    return {n: v for n, v in out.items() if v[0] is not None}


def _twin(name: str, mods: dict):
    first = next(iter(mods.values()))
    jf = _target(first, name)
    sig = inspect.signature(jf)
    local = {p for p in sig.parameters
             if _fixture(getattr(first, p, None)) is not None}
    fx_params = _fixture_params(first, local)
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
            cache = {("params", fx): kw.pop(_params_arg(fx))
                     for fx in fx_params}
            for fx in local:
                kw[fx] = _fixture_value(mod, fx, request, stack, cache)
            _target(mod, name)(**kw)

    params = [inspect.Parameter(
        "package", inspect.Parameter.POSITIONAL_OR_KEYWORD), *outer,
        *(inspect.Parameter(_params_arg(fx),
                            inspect.Parameter.POSITIONAL_OR_KEYWORD)
          for fx in fx_params)]
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
                       pytest.mark.parametrize("package", tuple(mods)),
                       *(pytest.mark.parametrize(_params_arg(fx), values,
                                                 ids=ids)
                         for fx, (values, ids) in fx_params.items())]
    return test


def twin_tests(module: str, names=None, packages=PACKAGES,
               absent=(), patch=None, port_patch=None, leave_out=(),
               torch_jnp=False) -> dict:
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
    backend query, said where it is used. ``leave_out`` names tests
    that are not twinned (TPU-only machinery or wording), each with its
    reason where it is used. ``torch_jnp``: the port twin's ``jax.numpy``
    makes CPU tensors (module docstring)."""
    mods = {pkg: _load(module, pkg, absent, patch, port_patch, torch_jnp)
            for pkg in packages}
    found = []
    for n, obj in vars(next(iter(mods.values()))).items():
        if n.startswith("test_") and inspect.isfunction(obj):
            found.append(n)
        elif n.startswith("Test") and inspect.isclass(obj):
            found += [f"{n}.{m}" for m, f in vars(obj).items()
                      if m.startswith("test_") and inspect.isfunction(f)]
    missing = set(leave_out) - set(found)
    assert not missing, f"{module} has no {sorted(missing)}"
    found = [n for n in found if n not in leave_out]
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
