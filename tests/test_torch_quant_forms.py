"""The int8 scale's arithmetic at every quantizer call site of the port,
held bit for bit to the site's JAX counterpart on the CPU.

The JAX package computes ``absmax / 127`` by true division where it
runs eagerly or in numpy, and as ``absmax * float32(1 / 127)`` under
``jax.jit`` (XLA folds the division by a constant); the values are then
divided by the scale in both. The two scales differ by one ulp for about
5 % of absmax values. So each port site names its counterpart's form
(``ops/quant.int8_scale``):

* the query planes, in the reciprocal form: ``ops/quant._quantize_queries``
  (the int8 scans; JAX ``quant.py:126`` / ``:343``, jitted by the engine
  and inside the pooled routes) and ``ops/ivf.batched_ivf_topk``
  (``_batched_core``, jitted);
* the stored planes: ``EmbeddingSlab.host_int8`` with its residual plane
  (the JAX slab's numpy quantizer: divide), ``quantized_view("int8")``
  (``jax.jit(scalar_quantize)``: reciprocal), ``ShardedCorpus.load``
  (an eager ``scalar_quantize``: divide) and ``ShardedIVFCorpus.load``
  (numpy: divide).

Every input row has an absmax where the two forms differ, and one entry
near a rounding tie of the scale, so a site in the wrong form fails on
its scales and, on some rows, its int8 values. Each test checks that its
input tells the forms apart before it compares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import quant as jquant
from neumann_tpu.ops import rerank as jrerank
from neumann_tpu.parallel import make_mesh as jmake_mesh
from neumann_tpu.parallel import sharded_search as jss
from neumann_tpu.store import embedding_slab as jslab
from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.ops import quant as tquant
from neumann_tpu_torch.ops import rerank as trerank
from neumann_tpu_torch.parallel import mesh as tmesh
from neumann_tpu_torch.parallel import sharded_search as tss
from neumann_tpu_torch.store import embedding_slab as tslab

INV_127 = np.float32(1.0) / np.float32(127.0)
_quantize = tquant.scalar_quantize
_jit_quantize = jax.jit(jquant.scalar_quantize)


def _differ(absmax: np.ndarray) -> np.ndarray:
    """Where absmax / 127 and absmax * float32(1 / 127) differ."""
    absmax = np.asarray(absmax, np.float32)
    return (absmax / np.float32(127.0)) != absmax * INV_127


def _chosen_rows(seed: int, n: int, d: int) -> np.ndarray:
    """[n, d] f32 rows: every absmax where the forms differ, and entry 1
    of each row (m + 1/2) steps of its divide-form scale, a tie that the
    reciprocal form's scale can round the other way."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 8.0, 40 * n).astype(np.float32)
    a = a[_differ(a)][:n]
    assert a.shape == (n,)
    x = (rng.uniform(-1.0, 1.0, (n, d)) * a[:, None]).astype(np.float32)
    x[:, 0] = np.where(rng.random(n) < 0.5, -a, a)
    m = rng.integers(-120, 120, n)
    x[:, 1] = ((m + 0.5) * (a / np.float32(127.0))).astype(np.float32)
    return x


def _numpy_quantize(x: np.ndarray):
    """The JAX slab's numpy quantizer (neumann_tpu/store/
    embedding_slab.py:233-236) and ShardedIVFCorpus's (sharded_search.py
    :296-299): true division throughout."""
    am = np.max(np.abs(x), axis=1)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / sc[:, None]), -127, 127).astype(np.int8), sc


def _assert_planes(got, want) -> None:
    for g, w, what in zip(got, want, ("int8 values", "scales")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(g.view(np.uint8 if g.dtype == np.int8
                                     else np.uint32),
                              w.view(np.uint8 if w.dtype == np.int8
                                     else np.uint32)), \
            (what, int((g != w).sum()))


class _Spy:
    """Records (input, form, output) of each ``scalar_quantize`` call a
    port module makes."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, form="divide"):
        out = _quantize(x, form=form)
        self.calls.append((x.detach().float().numpy().copy(), form,
                           tuple(t.numpy() for t in out)))
        return out


def test_chosen_rows_tell_the_forms_apart():
    """The inputs: scales differ on every row, the int8 values on some."""
    x = _chosen_rows(0, 256, 96)
    div = tquant.scalar_quantize(torch.from_numpy(x), form="divide")
    rec = tquant.scalar_quantize(torch.from_numpy(x), form="reciprocal")
    assert (div[1] != rec[1]).all()
    assert (div[0] != rec[0]).any(dim=1).sum() > 8
    with pytest.raises(ValueError, match="form"):
        tquant.int8_scale(div[1], form="multiply")


def test_forms_are_eager_and_jitted_jax():
    """"divide" is the eager JAX ``scalar_quantize`` and the numpy
    quantizer; "reciprocal" is ``jax.jit(scalar_quantize)``; the
    residual plane's "divide" the eager ``residual_quantize``."""
    x = _chosen_rows(1, 512, 64)
    xt = torch.from_numpy(x)
    div = tquant.scalar_quantize(xt, form="divide")
    _assert_planes(div, jquant.scalar_quantize(jnp.asarray(x)))
    _assert_planes(div, _numpy_quantize(x))
    _assert_planes(tquant.scalar_quantize(xt, form="reciprocal"),
                   _jit_quantize(jnp.asarray(x)))
    res = trerank.residual_quantize(xt, *div, form="divide")
    assert _differ(np.abs(x - div[0].numpy() * div[1].numpy()[:, None])
                   .max(axis=1)).any()
    _assert_planes(res, jrerank.residual_quantize(
        jnp.asarray(x), jnp.asarray(div[0].numpy()),
        jnp.asarray(div[1].numpy())))


def test_query_scans_quantize_as_jitted_jax(monkeypatch):
    """ops/quant.py's int8 scans (kernel 4's and 5's routes): their query
    planes are ``jax.jit(scalar_quantize)``'s."""
    spy = _Spy()
    monkeypatch.setattr(tquant, "scalar_quantize", spy)
    rng = np.random.default_rng(2)
    corpus = torch.from_numpy(rng.standard_normal((2048, 64)).astype(
        np.float32))
    cq, cs = _quantize(corpus)
    qs = torch.from_numpy(_chosen_rows(3, 16, 64))
    tquant.int8_topk_scan(cq, cs, qs, 10, "cosine")
    tquant.int8_pooled_topk(cq, cs, qs, 10, pool=8)
    assert [form for _, form, _ in spy.calls] == ["reciprocal"] * 2
    for x, _, out in spy.calls:
        assert _differ(np.abs(x).max(axis=1)).all()
        _assert_planes(out, _jit_quantize(jnp.asarray(x)))


def test_batched_ivf_queries_quantize_as_jitted_jax(monkeypatch):
    """ops/ivf.batched_ivf_topk (JAX ``_batched_core``, jitted): its
    int8 query plane of the unit queries."""
    rng = np.random.default_rng(4)
    n_win, window, d = 8, 512, 64
    cq, cs = tquant.scalar_quantize(torch.from_numpy(
        rng.standard_normal((n_win * window, d)).astype(np.float32)))
    rm = tquant.int8_cosine_row_mult(cq, cs)
    cents = torch.from_numpy(rng.standard_normal((n_win, d)).astype(
        np.float32))
    starts = torch.arange(n_win, dtype=torch.int32) * window
    # queries whose unit rows (the site's input) tell the forms apart
    cand = torch.from_numpy(rng.standard_normal((400, d)).astype(np.float32))
    qn = cand / cand.norm(dim=1, keepdim=True).clamp_min(1e-30)
    qs = cand[torch.from_numpy(_differ(qn.abs().amax(dim=1).numpy()))][:12]
    assert qs.shape[0] == 12
    spy = _Spy()
    monkeypatch.setattr(tivf, "scalar_quantize", spy)
    for kw in (dict(), dict(selection=4, fused="pallas")):
        spy.calls.clear()
        tivf.batched_ivf_topk(cq, rm, cents, starts, qs, 3, window, 8, 12,
                              **kw)
        (x, form, out), = spy.calls
        assert form == "reciprocal" and _differ(np.abs(x).max(axis=1)).all()
        _assert_planes(out, _jit_quantize(jnp.asarray(x)))


def test_slab_host_int8_is_the_numpy_quantizer(monkeypatch):
    """EmbeddingSlab.host_int8 (every IVF build's planes) against the JAX
    slab's numpy quantizer, both planes of ``residual=True`` included:
    the JAX slab runs its native C quantizer where that loads, so it is
    switched off here."""
    from neumann_tpu import native as jnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    x = _chosen_rows(5, 700, 96)
    j = jslab.EmbeddingSlab(96)
    t = tslab.EmbeddingSlab(96, device="cpu")
    for slab in (j, t):
        slab.set_rows(np.arange(700), x)
    _assert_planes(t.host_int8(), j.host_int8())
    got, want = t.host_int8(residual=True), j.host_int8(residual=True)
    _assert_planes(got[:2], want[:2])
    _assert_planes(got[2:], want[2:])
    res = x - got[0][:700, :96].astype(np.float32) * got[1][:700, None]
    assert _differ(np.abs(res).max(axis=1)).sum() > 10


def test_slab_quantized_view_is_jitted_jax():
    """EmbeddingSlab.quantized_view("int8") (the int8 collections' and
    the pooled routes' plane): ``jax.jit(scalar_quantize)`` of the JAX
    slab's device view."""
    x = _chosen_rows(6, 700, 96)
    j = jslab.EmbeddingSlab(96)
    t = tslab.EmbeddingSlab(96, device="cpu")
    for slab in (j, t):
        slab.set_rows(np.arange(700), x)
    got, want = t.quantized_view("int8"), j.quantized_view("int8")
    _assert_planes((got[0].numpy(), got[1].numpy()), want[:2])


def test_sharded_corpus_quantizes_as_eager_jax():
    """ShardedCorpus.load(quantized=True): the JAX class quantizes with
    an eager ``scalar_quantize``."""
    x = _chosen_rows(7, 300, 32)
    j = jss.ShardedCorpus(jmake_mesh(1), 32, quantized=True)
    t = tss.ShardedCorpus(tmesh.make_mesh(1, device="cpu"), 32,
                          quantized=True)
    j.load(x)
    t.load(x)
    _assert_planes((t.corpus[0].numpy(), t.scale[0].numpy()),
                   (j.corpus, j.scale))


def test_sharded_ivf_corpus_quantizes_as_numpy(monkeypatch):
    """ShardedIVFCorpus.load: the JAX class quantizes its rows in numpy."""
    spy = _Spy()
    monkeypatch.setattr(tss, "scalar_quantize", spy)
    t = tss.ShardedIVFCorpus(tmesh.make_mesh(1, device="cpu"), 48,
                             n_clusters=4, nprobe=2)
    t.load(_chosen_rows(8, 600, 48), seed=0)
    (x, form, out), = spy.calls
    assert form == "divide" and _differ(np.abs(x).max(axis=1)).mean() > 0.9
    _assert_planes(out, _numpy_quantize(x))
