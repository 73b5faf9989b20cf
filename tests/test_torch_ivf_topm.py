"""The non-fast batched IVF first pass (kernel 10: ``kernels.ivf_window_topm``,
``csrc/ivf_topm.cu`` on the card, its plain version here), the top-m of
every (probed window, table slot) in ``lax.top_k``'s order.

On the CPU the same numpy layouts and queries go through the JAX
package's ``batched_ivf_topk(selection="approx")`` (its XLA window scan,
``approx_max_k`` exact on the CPU) and the port's, and the plain version
is held to a numpy reference (int64 dots, f32 products, a stable sort):
a window holding copies of a row (and copies across windows), 30 % dead
rows and a dead window, m equal to the window and m above a window's live
rows, a layout of one window a cluster whose last window starts past the
buffer's end (rows clamped, positions from the unclamped start), windows
of 128 and 2,048 rows (the kernel's chunked form), d 768 and 1,536, and
a q_cap that overflowed once and its doubled retry. The queries are odd
integers near stored rows, so their norms, int8 planes and scales are
the same bits in both packages.

Tolerance: none. Scores are compared as bits and positions exactly: the
dots are exact integers, and the scale products are the same two f32
roundings in both packages. One departure of the reference is put
right before the comparison: at m equal to the window, JAX's
``approx_max_k`` sorts the whole window unstably on the CPU, so its
equal scores (copies, dead rows) come in no set order; there JAX's
positions are put in ``lax.top_k``'s order (ascending among equal
scores) within each probe's m, the order the port keeps at every m.

The kernel's plan (two blocks a SM up to d 4,096) and its selection
rule are pinned here too: a plain-torch model of its radix select on
32-bit score images (the m-th image found 8 bits at a time, the images
above it and the first at it by ascending offset, then only those keys
sorted) gives ``ops/scan._topk_stable``'s bits and offsets on all-equal
rows, a run of equal scores across the m-th place, dead rows at the
cut, m of 1 and of the window, all rows dead, images equal but in their
last byte, and signed zeros.

Under the ``cuda`` marker (skipped without a card) the kernel is held to
its plain version on the same cases and past them (windows of 128 to
4,096 rows, d 64 to 4,096, both slot groups of its plan, q_cap 1 to 200,
m 1 to the window; windows with 1, 16, 17, 32, 33 and 64 filled slots,
the edges of its groups; a run of 200 equal scores across the m-th
place at m 152, 256 and 257, on both sides of its in-register sort, and
past one chunk), scores and positions bit for bit on every filled slot,
and the route's output in full. This file imports JAX only inside the
CPU tests, so the card runs it with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.ops import kernels as tk


def _layout(n_win, window, d, seed, dead=0.05, clamp=False):
    """A window layout as numpy arrays: rows near their window's centre,
    int8 with per-row scales; rmult the cosine multiplier, 0 on ``dead``
    of the rows; window 2's rows 3-10 copies of its row 2 and of window
    0's row 2 (equal dots within a window and across windows); windows
    at c * window, with the buffer cut by 192 rows where ``clamp`` (the
    last window's rows clamped back into it)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((n_win, d)).astype(np.float32)
    x = (np.repeat(cents, window, axis=0)
         + 0.5 * rng.standard_normal((n_win * window, d))).astype(np.float32)
    if n_win > 2:
        x[2 * window + 3:2 * window + 11] = x[2 * window + 2]
        x[2] = x[2 * window + 2]
    if clamp:
        x = x[:-192]
    am = np.abs(x).max(axis=1)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    buf = np.clip(np.round(x / sc[:, None]), -127, 127).astype(np.int8)
    norm = np.linalg.norm(buf.astype(np.float32), axis=1)
    rm = np.where(norm > 0, 1.0 / np.maximum(norm, 1e-30), 0.0)
    rm = rm.astype(np.float32)
    rm[rng.random(len(rm)) < dead] = 0.0
    cn = cents / np.linalg.norm(cents, axis=1, keepdims=True)
    starts = (np.arange(n_win) * window).astype(np.int32)
    return dict(x=x, buf=buf, rm=rm, cents=cn, starts=starts, window=window)


def _queries(lay, q, seed):
    """Odd integers near 2x stored rows, the first two near the copied
    row: exact norms in both packages, and no entry of x / scale within
    an ulp of a half."""
    rng = np.random.default_rng(seed)
    x = lay["x"]
    pick = rng.choice(len(x), q)
    if len(x) > 3 * lay["window"]:
        pick[:2] = 2 * lay["window"] + 2
    return (2 * np.round(x[pick]) + 1).astype(np.float32)


# name: (windows, window, d, dead share, clamp, m, nprobe, q, q_cap)
CASES = {
    "copies": (6, 256, 64, 0.05, False, 24, 3, 16, 16),
    "dead_rows": (6, 256, 64, 0.3, False, 24, 3, 16, 16),
    "m_window": (5, 128, 64, 0.05, False, 128, 2, 12, 16),
    "m_above_live": (5, 128, 64, 0.9, False, 40, 2, 12, 16),
    "clamped": (5, 256, 64, 0.05, True, 24, 3, 16, 16),
    "window128": (8, 128, 64, 0.05, False, 20, 3, 16, 16),
    "window2048": (3, 2048, 64, 0.05, False, 70, 2, 8, 8),
    "d768": (4, 256, 768, 0.05, False, 24, 2, 8, 8),
    "d1536": (4, 256, 1536, 0.05, False, 24, 2, 8, 8),
    "overflow": (4, 256, 64, 0.05, False, 24, 3, 16, 8),
}


def _case(name):
    n_win, window, d, dead, clamp, m, nprobe, q, q_cap = CASES[name]
    lay = _layout(n_win, window, d, len(name), dead, clamp)
    if name == "dead_rows":
        lay["rm"][window:2 * window] = 0.0        # a whole window dead
    if name == "m_above_live":
        lay["rm"][:window] = 0.0
        lay["rm"][5:9] = 1.0 / np.linalg.norm(
            lay["buf"][5:9].astype(np.float32), axis=1)
    return lay, m, nprobe, _queries(lay, q, len(name) + 1), q_cap


def _port(lay, dev="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (lay["buf"], lay["rm"], lay["cents"],
                           lay["starts"]))


def _by_position_among_equals(s, p, m):
    """Positions p [Q, probes * m] reordered within each probe's m so
    that equal scores s come by ascending position."""
    out = p.copy()
    for q in range(s.shape[0]):
        for b0 in range(0, s.shape[1], m):
            img = s[q, b0:b0 + m].view(np.int32).astype(np.int64)
            img = np.where(img < 0, img ^ 0x7FFFFFFF, img)
            order = np.lexsort((p[q, b0:b0 + m], -img))
            out[q, b0:b0 + m] = p[q, b0:b0 + m][order]
    return out


@pytest.mark.parametrize("name", CASES)
def test_non_fast_first_pass_equals_jax(name):
    """The route's scores (as bits) and positions equal JAX's, in its
    column order, and so does the overflow; the overflowing q_cap also
    at its doubled retry, which overflows no more."""
    import jax.numpy as jnp

    from neumann_tpu.ops import ivf as jivf

    lay, m, nprobe, qs, q_cap = _case(name)
    window = lay["window"]
    caps = (q_cap, 2 * q_cap) if name == "overflow" else (q_cap,)
    for cap in caps:
        want = jivf.batched_ivf_topk(
            *(jnp.asarray(lay[k]) for k in ("buf", "rm", "cents", "starts")),
            jnp.asarray(qs), nprobe, window, m, cap)
        got = tivf.batched_ivf_topk(*_port(lay), torch.from_numpy(qs),
                                    nprobe, window, m, cap)
        s_w, p_w = np.asarray(want[0]), np.asarray(want[1])
        assert got[2] == int(want[2])
        assert got[0].shape == s_w.shape == (len(qs), nprobe * m)
        np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                      s_w.view(np.int32))
        if m == window:
            # approx_max_k of the whole window sorts unstably on the CPU:
            # JAX's equal scores (copies, dead rows) come in no set order
            # there, so they are put in lax.top_k's order (by ascending
            # position within each probe's m), which the port keeps
            p_w = _by_position_among_equals(s_w, p_w, m)
        np.testing.assert_array_equal(got[1].numpy(), p_w)
        assert np.isfinite(s_w).any()
    if name == "overflow":
        assert got[2] == 0 and tivf.batched_ivf_topk(
            *_port(lay), torch.from_numpy(qs), nprobe, window, m,
            q_cap)[2] > 0
    if name == "copies":
        # a window's copies of one row: equal scores, ascending positions
        s, p = got[0].numpy(), got[1].numpy()
        same = (s[:, 1:] == s[:, :-1]) & np.isfinite(s[:, 1:])
        assert same.any()
        assert (p[:, 1:][same] > p[:, :-1][same]).all()
    if name == "clamped":
        assert (got[1].numpy() >= len(lay["buf"])).any()
    if name == "m_above_live":
        s, p = got[0].numpy(), got[1].numpy()
        assert np.isneginf(s).any() and (p >= 0).all()


def _tables(lay, qs, nprobe, q_cap, dev="cpu"):
    """The plain version's inputs for a layout: (buf, rmult, first, base,
    tbl, qq, qsc) of the probed windows, as the route builds them."""
    from neumann_tpu_torch.ops.quant import scalar_quantize

    buf, rm, cents, starts = _port(lay, dev)
    q = torch.from_numpy(qs).to(dev)
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-30)
    probe = tivf._probe_windows(qn, cents, nprobe, "exact")
    tbl, _, _ = tivf._query_tables(probe, cents.shape[0], q_cap)
    qq, qsc = scalar_quantize(qn, form="reciprocal")
    live = torch.nonzero(tbl[:, 0] >= 0).flatten()
    base = starts[live].long()
    first = base.clamp(0, buf.shape[0] - lay["window"])
    return buf, rm, first, base, tbl[live].contiguous(), qq, qsc


def _reference(buf, rm, first, base, tbl, qq, qsc, window, m):
    """numpy: int64 dots, f32 products, a stable descending sort of the
    score's total-order image."""
    buf, rm, first, base, tbl, qq, qsc = (
        t.cpu().numpy() for t in (buf, rm, first, base, tbl, qq, qsc))
    out = {}
    for li, c0 in enumerate(first):
        rows = buf[c0:c0 + window].astype(np.int64)
        rmw = rm[c0:c0 + window]
        for s, qi in enumerate(tbl[li]):
            if qi < 0:
                continue
            dots = (rows @ qq[qi].astype(np.int64)).astype(np.float32)
            sc = np.where(rmw > 0, dots * (qsc[qi] * rmw),
                          np.float32(-np.inf)).astype(np.float32)
            img = sc.view(np.int32)
            img = np.where(img < 0, img ^ 0x7FFFFFFF, img)
            order = np.argsort(-img.astype(np.int64), kind="stable")[:m]
            out[li, s] = (sc[order], (base[li] + order).astype(np.int32))
    return out


def _filled_equal(got, want_ref):
    s, p = (t.cpu().numpy() for t in got)
    for (li, sl), (ws, wp) in want_ref.items():
        np.testing.assert_array_equal(s[li, sl].view(np.int32),
                                      ws.view(np.int32))
        np.testing.assert_array_equal(p[li, sl], wp)


@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_numpy(name):
    """``ivf_window_topm_plain`` on every filled slot equals int64 dots,
    f32 products and a stable sort, bit for bit; the wrapper takes it on
    the CPU and counts no launch."""
    lay, m, nprobe, qs, q_cap = _case(name)
    args = _tables(lay, qs, nprobe, q_cap)
    before = dict(tk.LAUNCHES)
    got = tk.ivf_window_topm(*args, lay["window"], m)
    assert tk.LAUNCHES == before
    want = _reference(*args, lay["window"], m)
    assert want
    _filled_equal(got, want)


def test_plain_steps_change_no_result(monkeypatch):
    """Steps of one window give the bits of one step of all."""
    lay, m, nprobe, qs, q_cap = _case("copies")
    args = _tables(lay, qs, nprobe, q_cap)
    whole = tk.ivf_window_topm_plain(*args, lay["window"], m)
    monkeypatch.setattr(tk, "_windows_per_step", lambda *a: 1)
    stepped = tk.ivf_window_topm_plain(*args, lay["window"], m)
    filled = (args[4] >= 0)[:, :, None].expand_as(whole[0])
    assert torch.equal(whole[0][filled].view(torch.int32),
                       stepped[0][filled].view(torch.int32))
    assert torch.equal(whole[1][filled], stepped[1][filled])


@pytest.mark.parametrize("window,d,want", [
    (1024, 768, (16, 1024, 2)), (1024, 3072, (8, 1024, 2)),
    (1024, 4096, (8, 1024, 2)), (640, 768, (16, 1024, 2)),
    (128, 64, (16, 128, 2)), (2048, 768, (16, 1024, 2)),
    (4096, 16384, (8, 1024, 1)), (1024, 20480, (8, 1024, 1))])
def test_topm_plan_fits_shared_memory(window, d, want):
    """The kernel's plan: two blocks a SM (16 slots where they fit beside
    a 1,024-row chunk of 32-bit images, else 8) up to d 4,096; one block
    past it; the bytes it asks for fit the SM's 228 KB twice where it
    says two, and a block's 227 KB always."""
    slots, chunk, smem, per_sm = tk._topm_plan(window, d)
    assert (slots, chunk, per_sm) == want
    assert smem == (tk._TOPM_FIXED + -(-d // tk._TOPM_BK) * slots
                    * tk._TOPM_BK + slots * (chunk + 4) * 4)
    assert smem <= tk._TOPM_SMEM
    if per_sm == 2:
        assert smem <= tk._TOPM_SMEM2 and 2 * (smem + 1024) <= 233472
    else:
        assert smem > tk._TOPM_SMEM2
    with pytest.raises(ValueError):
        tk._topm_plan(window, 24576)


def _radix_topm_model(scores, k):
    """csrc/ivf_topm.cu's selection of one slot in plain torch: the
    scores' unsigned 32-bit images; the k-th largest found 8 bits at a
    time from the top (a histogram of the digit among the images that
    match the bits found so far, the digit's bin from the top by a
    cumulative count; a bin taken whole ends it); every image above the
    cut and the first of those at it by ascending offset; only those k
    keys sorted, descending. Returns (values, offsets, passes)."""
    from neumann_tpu_torch.ops.scan import _image

    signed = _image(scores[None])[0].long()
    img = (signed & 0xFFFFFFFF) ^ 0x80000000
    prefix = mask = passes = 0
    kk = k
    for shift in (24, 16, 8, 0):
        passes += 1
        hist = torch.bincount((img[(img & mask) == prefix] >> shift) & 255,
                              minlength=256)
        from_top = hist.flip(0).cumsum(0)
        i = int(torch.nonzero(from_top >= kk)[0])
        b = 255 - i
        kk -= int(from_top[i] - hist[b])
        prefix |= b << shift
        mask |= 255 << shift
        if int(hist[b]) == kk:
            break
    cut = img & mask
    kept = torch.cat([torch.nonzero(cut > prefix).flatten(),
                      torch.nonzero(cut == prefix).flatten()[:kk]])
    assert kept.numel() == k
    keys = (signed[kept] << 32) | (0xFFFFFFFF - kept)
    off = 0xFFFFFFFF - (keys.sort(descending=True).values & 0xFFFFFFFF)
    return scores[off], off, passes


def _adversarial(name, rows=1024):
    """(scores [rows] f32, k) of one adversarial case."""
    rng = np.random.default_rng(len(name))
    s = rng.standard_normal(rows).astype(np.float32) * 0.05
    k = 152
    if name == "all_equal":
        s[:] = 0.25
    elif name == "straddle":
        # 130 rows above a run of 60 equal scores: the 152nd is inside it
        s = -np.abs(s) - 1.0
        s[rng.choice(rows, 130, replace=False)] = 2.0
        run = rng.choice(np.flatnonzero(s < 0), 60, replace=False)
        s[run] = 0.5
    elif name == "dead_at_cut":
        s[rng.random(rows) < 0.9] = -np.inf      # fewer live rows than k
    elif name == "m1":
        s[[700, 300, 301]] = 3.0                 # equal maxima: 300 first
        k = 1
    elif name == "m_window":
        s[rng.random(rows) < 0.3] = -np.inf
        s[10:40] = s[9]
        k = rows
    elif name == "all_dead":
        s[:] = -np.inf
    elif name == "low_bits":
        # images equal but in their last byte: all four passes
        s = (np.float32(1.0) + rng.integers(0, 200, rows).astype(np.float32)
             * np.float32(2.0 ** -23)).astype(np.float32)
    elif name == "signed_zeros":
        s[:] = -1.0
        s[rng.choice(rows, 200, replace=False)] = 0.0
        s[rng.choice(np.flatnonzero(s == -1.0), 200, replace=False)] = -0.0
    return torch.from_numpy(s), k


@pytest.mark.parametrize("name", ["all_equal", "straddle", "dead_at_cut",
                                  "m1", "m_window", "all_dead", "low_bits",
                                  "signed_zeros", "random"])
def test_radix_select_rule_equals_topk_stable(name):
    """The kernel's selection rule (``_radix_topm_model``) gives
    ``ops/scan._topk_stable``'s values (as bits) and offsets: equal
    scores by ascending offset, dead rows at their own offsets, -0.0
    below +0.0, on runs of equal images across the cut and images equal
    but in their last byte."""
    from neumann_tpu_torch.ops.scan import _topk_stable

    s, k = _adversarial(name)
    got_v, got_i, passes = _radix_topm_model(s, k)
    want_v, want_i = _topk_stable(s[None], k)
    assert torch.equal(got_i, want_i[0])
    assert torch.equal(got_v.view(torch.int32), want_v[0].view(torch.int32))
    if name == "low_bits":
        assert passes == 4
    if name in ("all_equal", "all_dead"):
        assert torch.equal(got_i, torch.arange(k))


def test_argument_errors():
    lay, m, nprobe, qs, q_cap = _case("copies")
    args = _tables(lay, qs, nprobe, q_cap)
    with pytest.raises(ValueError):
        tk.ivf_window_topm(*args, lay["window"], lay["window"] + 1)
    with pytest.raises(ValueError):
        tk.ivf_window_topm(*args, lay["window"], 0)
    with pytest.raises(ValueError):
        tk.ivf_window_topm(args[0], *args[1:6], args[6].double(),
                           lay["window"], m)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _kernel_vs_plain(cuda, lay, qs, nprobe, q_cap, m):
    args = _tables(lay, qs, nprobe, q_cap, cuda)
    before = tk.LAUNCHES["ivf_topm_select"]
    got = tk.ivf_window_topm(*args, lay["window"], m)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ivf_topm_select"] > before
    want = tk.ivf_window_topm_plain(*args, lay["window"], m)
    filled = (args[4] >= 0)[:, :, None].expand_as(want[0])
    assert filled.any()
    assert torch.equal(got[0][filled].view(torch.int32),
                       want[0][filled].view(torch.int32))
    assert torch.equal(got[1][filled], want[1][filled])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain_at_the_cases(cuda, name):
    lay, m, nprobe, qs, q_cap = _case(name)
    _kernel_vs_plain(cuda, lay, qs, nprobe, q_cap, m)


# (windows, window, d, dead share, q, nprobe, q_cap, m): the kernel's
# chunks (128-4,096 rows, a window not a power of two), both slot groups
# (d 4,096: 8 slots), K stages ending inside 128 bytes (d 784, 80), q_cap
# not a multiple of a group, m 1 to the window
EDGES = [
    (16, 1024, 768, 0.02, 256, 8, 64, 152),
    (16, 1024, 768, 0.02, 256, 8, 200, 1024),
    (16, 1024, 768, 0.02, 64, 8, 1, 1),
    (6, 640, 768, 0.02, 64, 3, 37, 70),
    (4, 4096, 768, 0.02, 32, 2, 16, 71),
    (4, 4096, 768, 0.02, 32, 2, 16, 4096),
    (4, 2048, 64, 0.5, 32, 2, 16, 2048),
    (8, 1024, 4096, 0.02, 64, 4, 24, 152),
    (8, 1024, 3072, 0.02, 64, 4, 24, 152),
    (8, 256, 784, 0.02, 64, 4, 24, 40),
    (8, 128, 80, 0.02, 64, 4, 24, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGES)
def test_kernel_equals_plain_at_edges(cuda, edge):
    n_win, window, d, dead, q, nprobe, q_cap, m = edge
    lay = _layout(n_win, window, d, window + d + m, dead)
    lay["rm"][window:2 * window] = 0.0
    _kernel_vs_plain(cuda, lay, _queries(lay, q, m), nprobe, q_cap, m)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["copies", "clamped", "window2048",
                                  "overflow"])
def test_route_on_the_card_equals_the_cpu(cuda, name):
    """``batched_ivf_topk``'s non-fast output in full, on the card (the
    kernel) and on the CPU (the plain version): bit for bit."""
    lay, m, nprobe, qs, q_cap = _case(name)
    window = lay["window"]
    before = tk.LAUNCHES["ivf_topm_select"]
    got = tivf.batched_ivf_topk(*_port(lay, cuda),
                                torch.from_numpy(qs).to(cuda), nprobe,
                                window, m, q_cap)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ivf_topm_select"] > before
    want = tivf.batched_ivf_topk(*_port(lay), torch.from_numpy(qs), nprobe,
                                 window, m, q_cap)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])


def _group_inputs(dev, window, d, filled, seed, q_cap=64, run=0):
    """Row 10's inputs over three windows of random int8 rows (2 % dead):
    window l's table holds filled[l] slots of random queries, so a
    window's slot groups end where the plan's do; with ``run``, window
    1's rows 100 .. 100 + run are copies of its row 99 (and 20 more
    copies past them score 4 times higher), and every query of window 1
    is that row, so its m-th place lies inside a run of equal scores."""
    g = torch.Generator().manual_seed(seed)
    n_win = len(filled)
    buf = torch.randint(-127, 128, (n_win * window, d), generator=g,
                        dtype=torch.int8)
    rm = 1.0 / buf.float().norm(dim=1)
    rm[torch.rand(len(rm), generator=g) < 0.02] = 0.0
    n_q = 96
    qq = torch.randint(-127, 128, (n_q, d), generator=g, dtype=torch.int8)
    if run:
        r0 = window + 100
        buf[r0:r0 + run + 20] = buf[r0 - 1]
        rm[r0 - 1:r0 + run] = rm[r0 - 1] if rm[r0 - 1] > 0 else 1e-3
        rm[r0 + run:r0 + run + 20] = 4 * rm[r0]
        qq[:] = buf[r0 - 1]
    qsc = torch.rand(n_q, generator=g) * 1e-2 + 1e-3
    tbl = torch.full((n_win, q_cap), -1, dtype=torch.int64)
    for li, f in enumerate(filled):
        tbl[li, :f] = torch.randperm(n_q, generator=g)[:f]
    first = torch.arange(n_win, dtype=torch.int64) * window
    return tuple(t.to(dev) for t in (buf, rm, first, first.clone(), tbl, qq,
                                     qsc))


def _direct_vs_plain(args, window, m):
    before = tk.LAUNCHES["ivf_topm_select"]
    got = tk.ivf_window_topm(*args, window, m)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ivf_topm_select"] > before
    want = tk.ivf_window_topm_plain(*args, window, m)
    filled = (args[4] >= 0)[:, :, None].expand_as(want[0])
    assert torch.equal(got[0][filled].view(torch.int32),
                       want[0][filled].view(torch.int32))
    assert torch.equal(got[1][filled], want[1][filled])
    return got


# filled slots at the edges of the plan's groups of 16 (and one window
# with 64: all four groups of a q_cap of 64)
@pytest.mark.cuda
@pytest.mark.parametrize("filled", [1, 16, 17, 32, 33, 64])
def test_kernel_equals_plain_at_group_edges(cuda, filled):
    args = _group_inputs(cuda, 1024, 768, (filled, 64 - filled, filled),
                         filled)
    _direct_vs_plain(args, 1024, 152)


# a run of 200 equal scores across the m-th place, 20 higher ones above
# it: the warp's radix select (m up to 256), the block's sort (257), one
# window past a chunk (4,096 rows)
@pytest.mark.cuda
@pytest.mark.parametrize("window,m", [(1024, 152), (1024, 256),
                                      (1024, 257), (4096, 152)])
def test_kernel_meets_ties_across_the_cut(cuda, window, m):
    args = _group_inputs(cuda, window, 768, (5, 17, 3), window + m, run=200)
    got = _direct_vs_plain(args, window, m)
    s, p = got[0][1, :17].cpu(), got[1][1, :17].cpu()
    same = s[:, 1:] == s[:, :-1]
    assert int(same.sum()) >= 17 * (min(m, 220) - 21)
    assert (p[:, 1:][same] > p[:, :-1][same]).all()
