"""IVF indexes on one GPU (port of ``neumann_tpu/ops/ivf.py``): the
windowed int8 index behind the engine's auto-IVF route
(``DeviceIVFInt8``), and the legacy ``IVFIndex`` behind the engine's
``build_ivf_index`` API (one padded block of rows a k-means cluster, in
flat f32, PQ-code or sign-bit storage; its pq storage scores the probed
rows with the ADC kernel, ``ops/kernels.pq_adc_topk`` in its gathered
mode).

Layout (same as the JAX package): rows sorted by k-means cluster into a
buffer of exactly corpus size, chopped into disjoint fixed windows of
``window`` rows whose probe centroids are the normalized window means
(``window_mean_centroids``); k-means only decides the sort order. The
legacy one-window-per-cluster layout (``fixed_window=None``) is built
too; its windows may overlap, so the rerank dedups.

Two first passes, each a hand-written CUDA kernel (``ops/kernels.py``):

* ``search`` (latency, batches up to ``ivf_auto_max_batch``):
  ``windowed_ivf_topk`` — top-nprobe windows per query, the probe kernel
  scores every row of them, exact top-kk; then the exact f32 rerank.
* ``search_batched`` (throughput): ``batched_ivf_topk`` — per-window
  query tables, one batched top-2 kernel pass that reads each window
  once per batch, packed-bits preselection; then the chunked rerank.

Not ported yet for ``DeviceIVFInt8`` (each raises
``NotImplementedError`` naming its ROADMAP item): incremental ``add`` /
``delete`` / ``compact`` (the delta plane),
and the non-fast batched variants (approx / streamed / XLA-fused window
scans). The default engine config never reaches them at >= 4M rows: the
auto window is then 1,024 rows, so the pool is 8 and the fast path is
always taken.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops import kernels
from neumann_tpu_torch.ops.kernels import (
    batched_probe,
    decode_strided_pool_bits,
    ivf_windowed_topk,
)
from neumann_tpu_torch.ops.pq import PQCodebook, PQConfig, to_f32
from neumann_tpu_torch.ops.quant import (
    binary_quantize,
    int8_cosine_row_mult,
    scalar_quantize,
)
from neumann_tpu_torch.ops.rerank import (
    gather_rerank_topk,
    gather_rerank_topk_chunked,
)
from neumann_tpu_torch.ops.scan import _topk_stable, host_pull

_NOT_PORTED_MUTATION = ("incremental IVF mutation (add/delete/compact and "
                        "the delta plane) is not ported yet (ROADMAP: IVF "
                        "delta plane)")
_NOT_PORTED_BATCHED = ("only the fast batched IVF path (fixed power-of-two "
                       "pool windows, fused kernel, presel) is ported; the "
                       "approx/streamed/XLA-fused variants are not "
                       "(ROADMAP: non-fast batched IVF variants)")


def window_mean_centroids(buf: torch.Tensor, rmult: torch.Tensor,
                          window: int, chunk_rows: int = 1 << 18
                          ) -> torch.Tensor:
    """Per-window probe centroids of a FIXED-window layout: the
    normalized mean of each window's unit rows (row x rmult), zero for
    all-padding windows. Computed in row chunks so the f32 upcast never
    holds more than ``chunk_rows`` x d."""
    n_pad, d = buf.shape
    if n_pad % window:
        raise ValueError(f"n_pad {n_pad} not a multiple of window {window}")
    chunk_rows = max(window, (chunk_rows // window) * window)
    parts = []
    for s in range(0, n_pad, chunk_rows):
        x = buf[s:s + chunk_rows].float() * rmult[s:s + chunk_rows, None]
        parts.append(x.reshape(-1, window, d).sum(dim=1))
    sums = torch.cat(parts)
    norm = sums.norm(dim=1, keepdim=True)
    return torch.where(norm > 0, sums / norm.clamp_min(1e-30),
                       torch.zeros_like(sums))


class DeviceIVFInt8:
    """IVF over a device-resident int8 corpus (see the module docstring
    and ``neumann_tpu.ops.ivf.DeviceIVFInt8`` for the layout's design).
    All device state lives on ``device``."""

    def __init__(self, dim: int, n_clusters: int = 1024, nprobe: int = 32,
                 iters: int = 12, max_read_frac: float = 0.02,
                 device="cuda"):
        self.dim = dim
        self.device = torch.device(device)
        self.n_clusters = n_clusters
        # cap on the corpus fraction one query reads (see build)
        self.max_read_frac = max_read_frac
        self._kmeans_k = n_clusters   # survives the fixed-window overwrite
        self.nprobe = nprobe
        self._nprobe_cfg = nprobe     # cluster-unit config (see build)
        self.iters = iters
        self.centroids = None         # [n_windows, d] f32 (unit norm)
        self._buf = None              # [n_pad, d] int8, cluster-sorted
        self._rmult = None            # [n_pad] f32 (0 = invalid row)
        self._scale = None            # [n_pad] f32 sorted int8 scales
        self._rbuf = None             # optional residual int8 plane
        self._rscale = None           # optional residual scales
        self._starts = None           # [n_windows] int32 window starts
        self._row_ids = None          # host [n] int32 (sorted order)
        self._window = 0
        self._fixed = False           # disjoint fixed windows (no dedup)
        self._n = 0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_device_layout(cls, dim, centroids, buf, rmult, starts, row_ids,
                           window, nprobe=32, scale=None, residual=None,
                           fixed=False, device=None):
        """Assemble from an already cluster-sorted corpus (tensors on
        one device). ``residual`` = (rq [n, d] int8, rscale [n] f32) in
        the SAME sorted order; fixed=True marks a disjoint fixed-window
        layout (skips rerank dedup)."""
        ivf = cls(dim, n_clusters=int(centroids.shape[0]), nprobe=nprobe,
                  device=device if device is not None else buf.device)
        ivf.centroids = centroids
        ivf._buf = buf
        ivf._rmult = rmult
        ivf._scale = scale
        if residual is not None:
            ivf._rbuf, ivf._rscale = residual
        ivf._starts = starts
        ivf._row_ids = row_ids
        ivf._window = int(window)
        ivf._fixed = bool(fixed)
        ivf._n = int(buf.shape[0])
        return ivf

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "DeviceIVFInt8":
        """An index from host arrays (``convert.ivf_state_from_jax``):
        the same layout, searched by the port."""
        def dev(a):
            return None if a is None else torch.from_numpy(
                np.array(a)).to(device)

        residual = None
        if state.get("_rbuf") is not None:
            residual = (dev(state["_rbuf"]), dev(state["_rscale"]))
        ivf = cls.from_device_layout(
            int(state["centroids"].shape[1]), dev(state["centroids"]),
            dev(state["_buf"]), dev(state["_rmult"]),
            dev(np.asarray(state["_starts"], np.int32)),
            np.asarray(state["_row_ids"]), int(state["_window"]),
            nprobe=int(state["nprobe"]), scale=dev(state.get("_scale")),
            residual=residual, fixed=bool(state["_fixed"]), device=device)
        return ivf

    def build(self, corpus_q: np.ndarray, corpus_scale: np.ndarray,
              sample_rows: int = 200_000, seed: int = 0,
              chunk_rows: int = 1 << 20,
              sample_mask: Optional[np.ndarray] = None,
              residual: Optional[Tuple[np.ndarray, np.ndarray]] = None,
              fixed_window="auto") -> None:
        """corpus_q int8 [N, d] and per-row scale, both on HOST.
        sample_mask limits the k-means sample to true rows; residual =
        (rq, rscale) host arrays in CORPUS order, stored sorted beside
        the corpus for the rerank. fixed_window: "auto" (default) or a
        multiple of 128 for disjoint fixed windows with window-mean
        probe centroids; None/0 for one window per cluster. ``seed``
        draws the k-means sample and seeds the device k-means init."""
        from neumann_tpu_torch.parallel.partitioner import (
            kmeans,
            kmeans_device,
        )

        dev = self.device
        n, d = corpus_q.shape
        rng = np.random.default_rng(seed)
        pool = (np.flatnonzero(sample_mask)
                if sample_mask is not None else np.arange(n))
        if pool.size == 0:
            pool = np.arange(n)
        pick = rng.choice(pool, size=min(sample_rows, pool.size),
                          replace=False)
        sample = corpus_q[pick].astype(np.float32) \
            * corpus_scale[pick][:, None]
        sample /= np.maximum(
            np.linalg.norm(sample, axis=1, keepdims=True), 1e-30)
        kk_means = self._kmeans_k or self.n_clusters
        if sample.size >= (1 << 24):
            # big samples train on device: random init + balance
            # reseeding (k-means++ seeding is a k-step host loop)
            cents = kmeans_device(torch.from_numpy(sample).to(dev),
                                  kk_means, self.iters, seed=seed)
        else:
            cents = torch.from_numpy(
                kmeans(sample, kk_means, self.iters, device=dev)).to(dev)
        cents = cents / cents.norm(dim=1, keepdim=True).clamp_min(1e-30)
        self.centroids = cents

        # nearest centroid by cosine, in chunks, in full f32: rows must
        # land in the window the f32 query-side probe ranks first
        assign = np.empty(n, np.int64)
        for s in range(0, n, chunk_rows):
            x = torch.from_numpy(corpus_q[s:s + chunk_rows]).to(dev).float()
            inv = torch.rsqrt((x * x).sum(1, keepdim=True).clamp_min(1e-30))
            assign[s:s + chunk_rows] = ((x * inv) @ cents.T).argmax(
                dim=1).cpu().numpy()

        counts = np.bincount(assign, minlength=kk_means)
        order = np.argsort(assign, kind="stable").astype(np.int32)
        if fixed_window:
            if fixed_window == "auto":
                avg = max(1, n // max(1, kk_means))
                window = int(min(1024, max(128, -(-avg // 128) * 128)))
            else:
                window = int(fixed_window)
                if window % 128:
                    raise ValueError("fixed_window must be a multiple of 128")
            n_pad = -(-n // window) * window
            starts = np.arange(n_pad // window, dtype=np.int32) * window
        else:
            starts = np.zeros(kk_means, np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            window = int(((max(int(counts.max()), 1) + 127) // 128) * 128
                         + 128)
            n_pad = ((n + 127) // 128) * 128
            window = min(window, n_pad)
            starts = ((np.clip(starts, 0, max(0, n_pad - window)) // 128)
                      * 128).astype(np.int32)

        # relayout by chunked scatter through the inverse permutation:
        # each host chunk is uploaded once, straight to its sorted rows
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)

        def scatter_plane(src):
            plane = torch.zeros((n_pad, d), dtype=torch.int8, device=dev)
            for s in range(0, n, chunk_rows):
                plane[torch.from_numpy(inv[s:s + chunk_rows]).to(dev)] = \
                    torch.from_numpy(src[s:s + chunk_rows]).to(dev)
            return plane

        def sorted_scales(sc):
            out = sc[order].astype(np.float32)
            if n_pad != n:     # padding rows: scale 1, rmult 0
                out = np.concatenate([out, np.ones(n_pad - n, np.float32)])
            return torch.from_numpy(out).to(dev)

        self._buf = scatter_plane(corpus_q)
        self._scale = sorted_scales(corpus_scale)
        # one pass over the sorted int8 plane, in chunks: the f32
        # upcast of a whole 4M x 768 plane would be 12.9 GB
        step = 1 << 18
        self._rmult = torch.cat([
            int8_cosine_row_mult(self._buf[s:s + step],
                                 self._scale[s:s + step])
            for s in range(0, n_pad, step)])
        if residual is not None:
            rq, rsc = residual
            self._rbuf = scatter_plane(rq)
            self._rscale = sorted_scales(rsc)
        else:
            self._rbuf = self._rscale = None
        self._starts = torch.from_numpy(starts).to(dev)
        self._row_ids = order
        self._window = window
        self._fixed = bool(fixed_window)
        if self._fixed:
            # the windows become the probe domain; recalibrate nprobe
            # from cluster units to window units so the intended READ
            # FRACTION survives, capped at max_read_frac (floor 64)
            self.centroids = window_mean_centroids(self._buf, self._rmult,
                                                   window)
            self.n_clusters = int(self.centroids.shape[0])
            avg = max(1, n // max(1, kk_means))
            cap = max(64, int(self.max_read_frac * n) // window)
            self.nprobe = int(max(1, min(
                self.n_clusters, cap,
                -(-self._nprobe_cfg * avg // window))))
        self._n = n

    # ------------------------------------------------------------------
    # mutation (not ported yet)
    # ------------------------------------------------------------------
    def add(self, vectors):
        raise NotImplementedError(_NOT_PORTED_MUTATION)

    def delete(self, ids):
        raise NotImplementedError(_NOT_PORTED_MUTATION)

    def compact(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED_MUTATION)

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def _ids_of(self, pos: np.ndarray) -> np.ndarray:
        return np.where(pos >= 0,
                        np.asarray(self._row_ids)[np.maximum(pos, 0)], -1)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Latency path: probe kernel first pass (oversampled to 4k+16
        to cover window-overlap duplicates), exact f32 rerank (+residual
        plane when built). Returns host (scores [Q, k], ids [Q, k])."""
        if self._buf is None:
            raise ValueError("build() first")
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        kk = min(4 * k + 16, self._window * nprobe)
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        sc, pc = ivf_windowed_topk(self._buf, self._rmult, self.centroids,
                                   self._starts, qd, kk, nprobe,
                                   self._window)
        sc, pc = gather_rerank_topk(
            self._buf, pc, qd, k, "cosine", scale=self._scale,
            residual_q=self._rbuf, residual_scale=self._rscale,
            first_scores=sc, dedup=not self._fixed)
        s, pos = host_pull(sc, pc)
        return s, self._ids_of(pos).astype(np.int32)

    def batched_fast_ok(self, k: int) -> bool:
        """Whether ``search_batched`` can take the fast path: disjoint
        fixed windows of a power-of-two number (>= 2) of 128-row pools,
        and k <= 128 (the packed-bits presel keeps at most 512 distinct
        candidates per query)."""
        pool = self._window // 128
        return (self._fixed and self._window % 128 == 0 and pool >= 2
                and (pool & (pool - 1)) == 0 and k <= 128)

    def search_batched(self, queries: np.ndarray, k: int,
                       nprobe: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Throughput path: probe-sharing batched first pass through the
        top-2 kernel + packed-bits preselection, then the chunked exact
        rerank. Queries pad to power-of-two buckets; q_cap (max queries
        per window) starts at ~3x the uniform expectation and doubles on
        overflow. Only the fast path is ported (``batched_fast_ok``)."""
        if self._buf is None:
            raise ValueError("build() first")
        if not self.batched_fast_ok(k):
            raise NotImplementedError(_NOT_PORTED_BATCHED)
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        q_pad = max(8, 1 << (nq - 1).bit_length())
        if q_pad != nq:
            q = np.concatenate(
                [q, np.zeros((q_pad - nq, q.shape[1]), np.float32)])
        expect = -(-q_pad * nprobe // self.n_clusters)
        q_cap = max(64, -(-(3 * expect) // 64) * 64) if q_pad > 64 else \
            (1 << (max(16, 4 * expect) - 1).bit_length())
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        valid = torch.arange(q_pad, device=self.device) < nq
        pmode = "pool" if nprobe < self.n_clusters else "exact"
        # the top-2 kernel + packed-bits presel keep O(3k) candidates
        presel = min(max(3 * k + 2, 32), nprobe * 256)
        while True:
            sc, pos, overflow = batched_ivf_topk(
                self._buf, self._rmult, self.centroids, self._starts, qd,
                nprobe, self._window, q_cap, valid_q=valid,
                probe_mode=pmode, presel=presel)
            if overflow == 0 or q_cap >= q_pad:
                break     # q_cap == q_pad can never overflow
            q_cap *= 2
        sc, pos = gather_rerank_topk_chunked(
            self._buf, pos, qd, k, "cosine", scale=self._scale,
            residual_q=self._rbuf, residual_scale=self._rscale,
            first_scores=sc, dedup=not self._fixed, chunk=min(128, q_pad))
        s, p = host_pull(sc[:nq], pos[:nq])
        return s, self._ids_of(p).astype(np.int32)


# --------------------------------------------------------------------------
# Batched IVF: probe-sharing throughput pass (see the block comment in
# neumann_tpu/ops/ivf.py). Windows stream once per batch, each scored
# only against the queries that probed it: probe selection, per-window
# query tables, one batched kernel launch, packed-bits preselection.
# --------------------------------------------------------------------------

def _probe_windows(qn, cents, nprobe: int, probe_mode: str):
    """[Q, nprobe] probed windows; C (sentinel) for dead pool picks."""
    n_c = cents.shape[0]
    if probe_mode == "pool" and n_c > nprobe:
        # one winner per strided pool of the score row (the JAX
        # package's single-max-pass probe pick): scores in [1, 3) with
        # the pool member packed into the low mantissa bits
        sc_c = (qn.to(torch.bfloat16).float()
                @ cents.to(torch.bfloat16).float().T)
        cp2 = -(-n_c // nprobe) * nprobe
        ppool = cp2 // nprobe
        lowb = max(1, (ppool - 1).bit_length())
        sp = torch.nn.functional.pad(sc_c, (0, cp2 - n_c),
                                     value=float("-inf")) + 2.0
        sp = torch.where(torch.isfinite(sp), sp.clamp(1.0, 2.9999998),
                         torch.zeros_like(sp))
        s3 = sp.reshape(qn.shape[0], ppool, nprobe)
        pi = torch.arange(ppool, device=qn.device,
                          dtype=torch.int32)[None, :, None]
        bits = (s3.view(torch.int32) & ~((1 << lowb) - 1)) | pi
        wb_p = bits.amax(dim=1)                             # [Q, nprobe]
        lane = torch.arange(nprobe, device=qn.device, dtype=torch.int32)
        probe = (wb_p & ((1 << lowb) - 1)) * nprobe + lane
        return torch.where(wb_p < 0x3F800000,
                           torch.full_like(probe, n_c), probe)
    if probe_mode == "exact":
        return torch.topk(qn @ cents.T, nprobe, dim=1)[1].int()
    raise NotImplementedError(
        f"probe_mode {probe_mode!r}: {_NOT_PORTED_BATCHED}")


def _query_tables(probe, n_c: int, q_cap: int):
    """Invert [Q, nprobe] probes into per-window query tables.

    rank(q, r) = number of queries q' < q probing the same window (a
    stable sort by window; within one query probes are distinct).
    Returns (tbl [C, q_cap] int64 query index or -1, rank_of [Q, nprobe]
    slot each probe holds or q_cap when dropped, overflow count)."""
    q, nprobe = probe.shape
    flat = probe.reshape(-1).long().clamp(max=n_c)          # n_c = drop
    sorted_w, order = torch.sort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_c + 1)
    run_start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) \
        - run_start[sorted_w]
    live = flat < n_c
    overflow = int(((rank >= q_cap) & live).sum())
    keep = live & (rank < q_cap)
    tbl = torch.full((n_c, q_cap), -1, dtype=torch.int64,
                     device=probe.device)
    qidx = torch.arange(q, device=probe.device).repeat_interleave(nprobe)
    tbl[flat[keep], rank[keep]] = qidx[keep]
    rank_of = torch.where(rank < q_cap, rank,
                          torch.full_like(rank, q_cap)).reshape(q, nprobe)
    return tbl, rank_of, overflow


def batched_ivf_topk(buf, rmult, cents, starts, qs, nprobe: int,
                     window: int, q_cap: int, valid_q=None,
                     probe_mode: str = "pool", presel: int = 0):
    """Probe-sharing batched IVF candidate pass over a fixed-window
    layout, through the batched top-2 kernel.

    buf/rmult/cents/starts: the DeviceIVFInt8 layout; qs [Q, d] f32
    queries; valid_q [Q] bool (False = padding query). presel > 0 runs
    the kernel in top-2 mode and keeps the ``presel`` best candidates per
    query straight from the packed bits; presel = 0 decodes every
    (probe, pool) winner. Returns (scores [Q, presel or nprobe*128] f32,
    positions in sorted-buffer coordinates int32 with -1 sentinels,
    overflow: probes dropped because more than q_cap queries probed
    one window — retry with a bigger q_cap if nonzero)."""
    pool = window // 128
    if window % 128 or pool < 1 or pool & (pool - 1):
        raise ValueError(f"batched kernel needs a power-of-two multiple of "
                         f"128 rows per window, got {window}")
    Q, d = qs.shape
    n_c = cents.shape[0]
    nw = n_c * window
    if valid_q is None:
        valid_q = torch.ones(Q, dtype=torch.bool, device=qs.device)
    qn = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
    probe = _probe_windows(qn, cents, nprobe, probe_mode)
    probe = torch.where(valid_q[:, None], probe, torch.full_like(probe, n_c))
    tbl, rank_of, overflow = _query_tables(probe, n_c, q_cap)

    qq_i8, qsc = scalar_quantize(qn)
    tsafe = tbl.clamp_min(0)
    qsel = qq_i8[tsafe.reshape(-1)].reshape(n_c, q_cap, d)
    sc_slot = torch.where(tbl >= 0, qsc[tsafe], torch.zeros_like(qsc[tsafe]))
    wb = batched_probe(buf[:nw], rmult[:nw].reshape(n_c, window), qsel,
                       sc_slot, window, top2=bool(presel))

    probe = probe.long()
    ok = (probe < n_c) & (rank_of < q_cap)
    cg = probe.clamp(max=n_c - 1)
    rk = rank_of.clamp(max=q_cap - 1)
    if presel:
        # packed-bits preselect on the raw kernel output: steal
        # log2(nprobe) more mantissa bits for the probe slot, reduce the
        # probe axis with a streaming top-2 (an equality mask isolates
        # the runner-up), then one exact top-k over [Q, 512]
        lanes = wb.shape[-1]
        wbg = torch.where(ok[:, :, None], wb[cg, rk],
                          torch.zeros((), dtype=wb.dtype, device=wb.device))
        kb = (pool - 1).bit_length()
        mb = max(1, (nprobe - 1).bit_length())
        pr_iota = torch.arange(nprobe, device=wb.device,
                               dtype=torch.int32)[None, :, None]
        bits2 = ((wbg & ~((1 << (mb + kb)) - 1)) | (pr_iota << kb)
                 | (wbg & (pool - 1)))
        m1 = bits2.amax(dim=1)                                # [Q, lanes]
        m2 = torch.where(bits2 == m1[:, None, :],
                         torch.zeros_like(bits2), bits2).amax(dim=1)
        cand = torch.cat([m1, m2], dim=1)
        sv, si = torch.topk(cand.view(torch.float32),
                            min(presel, 2 * lanes), dim=1)
        bits = sv.view(torch.int32)
        deadb = bits < 0x3F800000
        g_s = torch.where(
            deadb, torch.full_like(sv, float("-inf")),
            (bits & ~((1 << (mb + kb)) - 1)).view(torch.float32) - 2.0)
        local = bits & (pool - 1)
        pr = (bits >> kb) & ((1 << mb) - 1)
        lane = (si % lanes) % 128
        win = torch.gather(cg, 1, pr.long())
        g_p = torch.where(deadb, torch.full_like(bits, -1),
                          (starts[win] + local * 128 + lane).int())
        return g_s, g_p, overflow
    g_s, g_pos = decode_strided_pool_bits(wb[cg, rk], window)
    base = starts[cg][:, :, None]
    out_s = torch.where(ok[:, :, None], g_s, torch.full_like(g_s,
                                                             float("-inf")))
    out_p = torch.where(ok[:, :, None] & (g_pos >= 0), base + g_pos,
                        torch.full_like(g_pos, -1))
    return (out_s.reshape(Q, -1), out_p.reshape(Q, -1).int(), overflow)


# ---------------------------------------------------------------------------
# the legacy IVF index: one padded block of rows a k-means cluster
# ---------------------------------------------------------------------------

@dataclass
class IVFConfig:
    """Parity with IVFConfig::{flat,pq,binary}
    (tensor_store/src/ivf.rs:61-140): per-list storage is Flat f32,
    PQ codes (ADC scan), or packed sign bits (hamming scan)."""

    n_clusters: int = 64
    nprobe: int = 8
    iters: int = 20
    storage: str = "flat"        # flat | pq | binary
    pq_subspaces: int = 8

    @staticmethod
    def flat(n_clusters: int = 64) -> "IVFConfig":
        return IVFConfig(n_clusters=n_clusters)

    @staticmethod
    def pq(n_clusters: int = 64, n_subspaces: int = 8) -> "IVFConfig":
        return IVFConfig(n_clusters=n_clusters, storage="pq",
                         pq_subspaces=n_subspaces)

    @staticmethod
    def binary(n_clusters: int = 64) -> "IVFConfig":
        return IVFConfig(n_clusters=n_clusters, storage="binary")


# bytes of gathered candidates (or assignment scores) one step may hold
_LEGACY_STEP_BYTES = 1 << 28


def _padded_layout(v: torch.Tensor, assign: torch.Tensor, k: int,
                   min_stride: int = 0):
    """Cluster-sorted padded layout on v's device (the JAX package's
    ``_padded_layout`` and the re-pad of its ``_relayout``): cluster c's
    rows, in row order, fill rows [c * stride, c * stride + count).

    Returns (buf [k*stride, d] v's dtype, ids [k*stride] int32 with -1
    padding, stride), stride the largest cluster (at least
    ``min_stride``) rounded up to 8."""
    counts = torch.bincount(assign, minlength=k)
    stride = max(int(counts.max()) if len(assign) else 1, 1, min_stride)
    stride = (stride + 7) // 8 * 8
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    starts = torch.cumsum(counts, 0) - counts
    within = (torch.arange(len(v), device=v.device)
              - starts[sorted_assign])
    pos = sorted_assign * stride + within
    buf = torch.zeros((k * stride, v.shape[1]), dtype=v.dtype,
                      device=v.device)
    ids = torch.full((k * stride,), -1, dtype=torch.int32, device=v.device)
    buf[pos] = v[order]
    ids[pos] = order.int()
    return buf, ids, stride


class IVFIndex:
    """IVF over a cluster-sorted padded layout (port of
    ``neumann_tpu.ops.ivf.IVFIndex``): k-means centroids; every
    cluster's rows contiguous in one block of ``stride`` rows; a search
    scores its query's ``nprobe`` nearest blocks only. Storage per
    config: f32 rows (cosine), PQ codes (the ADC kernel, gathered mode)
    or sign bits (hamming). The planes live on ``device``; centroids and
    row ids are host numpy arrays, as in the JAX package."""

    def __init__(self, dim: int, config: Optional[IVFConfig] = None,
                 device="cuda"):
        self.dim = dim
        self.config = config or IVFConfig()
        self.device = torch.device(device)
        self.centroids: Optional[np.ndarray] = None  # [k, d]
        self._reordered = None     # device [k * stride, d] f32 (flat)
        self._codes = None         # device [k * stride, M] uint8 (pq)
        self._bits = None          # device [k * stride, W] int32 (binary)
        self._pq = None
        self._row_ids = None       # np [k * stride] original ids (-1 pad)
        self._stride = 0
        self._n = 0
        self._v = None             # device [n, d] originals (relayouts)
        self._counts = None        # np [k] rows per cluster
        self._valid = None         # device [k * stride] bool, cached
        self._cents = (None, None)  # (host array, its device copy)

    def train(self, sample) -> None:
        from neumann_tpu_torch.parallel.partitioner import kmeans

        self.centroids = kmeans(to_f32(sample, self.device),
                                self.config.n_clusters, self.config.iters,
                                device=self.device)

    def _dev_centroids(self) -> torch.Tensor:
        host, dev = self._cents
        if host is not self.centroids:
            dev = torch.from_numpy(np.ascontiguousarray(
                self.centroids, np.float32)).to(self.device)
            self._cents = (self.centroids, dev)
        return dev

    def _assign(self, v: torch.Tensor) -> torch.Tensor:
        """Nearest centroid (squared L2) of each row, on the device."""
        c = self._dev_centroids()
        cc = (c * c).sum(1)[None, :]
        step = max(1, _LEGACY_STEP_BYTES // (4 * len(c)))
        out = torch.empty(len(v), dtype=torch.int64, device=v.device)
        for r0 in range(0, len(v), step):
            x = v[r0:r0 + step]
            d2 = (x * x).sum(1)[:, None] - 2 * x @ c.T + cc
            out[r0:r0 + step] = d2.argmin(dim=1)
        return out

    def _encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows -> the storage plane's dtype (f32 / PQ codes / bits)."""
        storage = self.config.storage
        if storage == "pq":
            return self._pq.encode(rows)
        if storage == "binary":
            # in steps: binary_quantize holds int64 [rows, d] temporaries
            out = torch.empty((len(rows), -(-rows.shape[1] // 32)),
                              dtype=torch.int32, device=rows.device)
            step = max(1, _LEGACY_STEP_BYTES // (16 * rows.shape[1]))
            for r0 in range(0, len(rows), step):
                out[r0:r0 + step] = binary_quantize(rows[r0:r0 + step])
            return out
        return rows

    def _relayout(self, v: torch.Tensor, assign: torch.Tensor,
                  min_stride: int = 0) -> None:
        """Full cluster-sorted (re)layout with ``min_stride`` slack."""
        k = len(self.centroids)
        buf, ids, stride = _padded_layout(v, assign, k, min_stride)
        storage = self.config.storage
        self._reordered = self._codes = self._bits = None
        if storage == "pq":
            if self._pq is None:
                self._pq = PQCodebook(v.shape[1], PQConfig(
                    n_subspaces=self.config.pq_subspaces), self.device)
                self._pq.train(v)
            self._codes = self._pq.encode(buf)
        elif storage == "binary":
            self._bits = self._encode_rows(buf)
        else:
            self._reordered = buf
        self._row_ids = ids.cpu().numpy()
        self._stride = stride
        self._counts = torch.bincount(assign, minlength=k).cpu().numpy()
        self._n = len(v)
        self._valid = None

    def add(self, vectors):
        """APPEND vectors to a trained index (IVFIndex::add,
        tensor_store/src/ivf.rs:276) — no full rebuild per call. The
        first call lays out the cluster-sorted padded buffer; later
        calls scatter rows into their clusters' padding slack, and
        only a cluster OVERFLOW triggers an amortized stride-doubling
        relayout. Returns the new row id (1-D input) or ids array."""
        if self.centroids is None:
            raise ValueError("train() first")
        v = to_f32(vectors, self.device)
        single = v.ndim == 1
        if single:
            v = v[None, :]
        assign = self._assign(v)
        if self._v is None:               # first add: full layout
            self._v = v.clone()
            self._relayout(v, assign)
            ids = np.arange(len(v))
            return int(ids[0]) if single else ids
        base = self._n
        ids = np.arange(base, base + len(v))
        all_v = torch.cat([self._v, v])
        new_counts = self._counts.copy()
        np.add.at(new_counts, assign.cpu().numpy(), 1)
        if int(new_counts.max()) > self._stride:
            # amortized: relayout with doubled headroom
            all_assign = torch.cat([self._assign(self._v), assign])
            self._v = all_v
            self._relayout(all_v, all_assign,
                           min_stride=2 * int(new_counts.max()))
            return int(ids[0]) if single else ids
        # in-place append into each cluster's slack slots
        order = torch.argsort(assign, stable=True)
        srt = assign[order]
        run_start = torch.searchsorted(srt, srt, side="left")
        within = torch.arange(len(v), device=v.device) - run_start
        counts = torch.from_numpy(self._counts).to(v.device)
        pos = srt * self._stride + counts[srt] + within
        rows = self._encode_rows(v[order])
        plane = ("_codes" if self.config.storage == "pq" else
                 "_bits" if self.config.storage == "binary" else
                 "_reordered")
        getattr(self, plane)[pos] = rows
        pos_h = pos.cpu().numpy()
        self._row_ids[pos_h] = ids[order.cpu().numpy()].astype(np.int32)
        self._counts = new_counts
        self._v = all_v
        self._n += len(v)
        self._valid = None
        return int(ids[0]) if single else ids

    def search(self, queries, k: int, nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the nprobe nearest clusters per query (cosine to
        the normalized centroids): cosine over the gathered rows (flat),
        -hamming distance over their sign bits (binary) or -ADC distance
        (pq: the ADC kernel, each query scoring its own probed rows, the
        top-k selected inside it up to its k cap; ties by probe order).
        Returns host (scores [Q, kk], ids [Q, kk] int32), kk = min(k,
        nprobe * stride); -inf / -1 past the live rows."""
        storage = self.config.storage
        plane = {"pq": self._codes, "binary": self._bits}.get(
            storage, self._reordered)
        if plane is None:
            raise ValueError("add() first")
        nprobe = min(nprobe or self.config.nprobe, len(self.centroids))
        q = to_f32(queries, self.device)
        if q.ndim == 1:
            q = q[None, :]
        stride = self._stride
        if self._valid is None:
            self._valid = torch.from_numpy(self._row_ids >= 0).to(
                self.device)
        cents = self._dev_centroids()
        qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-30)
        cn = cents / cents.norm(dim=1, keepdim=True).clamp_min(1e-30)
        _, probe = _topk_stable(qn @ cn.T, nprobe)               # [Q, nprobe]
        cols = nprobe * stride
        kk = min(k, cols)
        width = plane.shape[1] * plane.element_size()
        step = max(1, min(65535, _LEGACY_STEP_BYTES // (cols * width)))
        span = torch.arange(stride, device=self.device)
        out_s, out_p = [], []
        for q0 in range(0, q.shape[0], step):
            qs = q[q0:q0 + step]
            pos = (probe[q0:q0 + step, :, None] * stride
                   + span).reshape(qs.shape[0], cols)
            if storage == "pq" and 1 <= kk <= kernels.PQ_ADC_TOPK_CAP:
                s, i = kernels.pq_adc_topk(
                    self._codes, self._pq.adc_tables(qs), self._valid, kk,
                    pos.int())
                out_s.append(s)
                out_p.append(torch.gather(pos, 1, i))
                continue
            if storage == "pq":
                scores = kernels.pq_adc_scores(
                    self._codes, self._pq.adc_tables(qs), self._valid,
                    pos.int())
            else:
                cand = plane[pos]                          # [q, C, w]
                if storage == "binary":
                    x = kernels._popcount32(
                        cand ^ binary_quantize(qs)[:, None, :])
                    scores = -x.sum(dim=2).float()
                else:
                    cn2 = cand.norm(dim=2).clamp_min(1e-30)
                    dots = torch.bmm(cand, qs[:, :, None])[:, :, 0]
                    scores = dots / (cn2 * qs.norm(
                        dim=1, keepdim=True).clamp_min(1e-30))
                scores = scores.masked_fill(~self._valid[pos],
                                            float("-inf"))
            s, i = _topk_stable(scores, kk)
            out_s.append(s)
            out_p.append(torch.gather(pos, 1, i))
        s, pos = host_pull(torch.cat(out_s), torch.cat(out_p))
        ids = np.where(pos >= 0, self._row_ids[np.maximum(pos, 0)], -1)
        ids = np.where(np.isneginf(s), -1, ids)
        return s, ids.astype(np.int32)

    def search_with_nprobe(self, queries, k: int, nprobe: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Name parity with IVFIndex::search_with_nprobe (ivf.rs:325)."""
        return self.search(queries, k, nprobe)

    @property
    def n_vectors(self) -> int:
        return self._n
