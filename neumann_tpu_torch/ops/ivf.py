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

First passes:

* ``search`` (latency, batches up to ``ivf_auto_max_batch``):
  ``windowed_ivf_topk`` — top-nprobe windows per query, the probe kernel
  (``csrc/ivf_probe.cu``) scores every row of them, exact top-kk; then
  the exact f32 rerank.
* ``search_batched`` (throughput): ``batched_ivf_topk`` — per-window
  query tables, every probed window read once per batch. The fast path
  (fixed windows of a power-of-two number of 128-row pools, k <= 128)
  runs the batched top-2 kernel (``csrc/batched_probe.cu``) and a
  packed-bits preselection; every other batch (k > 128, or another
  window) takes the JAX package's non-fast variant: exact int8 dots and
  the top-m of each (query, window) in one launch
  (``ops/kernels.ivf_window_topm``, ``csrc/ivf_topm.cu``), a
  preselection by first-pass score. Both end in the chunked exact
  rerank.

Incremental mutation (``add`` / ``delete`` / ``compact``): added rows go
to a device DELTA plane whose filled slots every search scans exactly
(``ops/quant.int8_exact_topk``: the ``int8_exact`` kernel on the card)
and merges over the windowed hits;
deletes zero a row's cosine multiplier in the main and delta planes;
``compact`` rebuilds the windowed layout from the live rows, keeping
their ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops import kernels
from neumann_tpu_torch.ops.kernels import _window_dots as _int8_dots
from neumann_tpu_torch.ops.kernels import (
    _windows_per_step,
    batched_probe,
    decode_strided_pool_bits,
    ivf_windowed_topk,
)
from neumann_tpu_torch.ops.pq import PQCodebook, PQConfig, to_f32
from neumann_tpu_torch.ops.quant import (
    binary_quantize,
    int8_cosine_row_mult,
    int8_exact_topk,
    scalar_quantize,
)
from neumann_tpu_torch.ops.rerank import (
    gather_rerank_topk,
    gather_rerank_topk_chunked,
)
from neumann_tpu_torch.ops.scan import NEG_INF, _topk_stable, host_pull


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
        # incremental mutation: appended rows live in a DELTA plane on
        # the device, scanned exactly and merged over the windowed hits;
        # deletes zero rmult
        self._dbuf = None             # [cap, d] int8 delta rows
        self._drmult = None           # [cap] f32 (0 = empty slot or dead)
        self._dscale = None           # [cap] f32
        self._dn = 0                  # filled delta slots
        self._dids = None             # host [cap] int64 delta row ids
        self._next_id = 0             # id counter (continues build ids)
        self._pos_of = None           # host inverse: original id -> pos
        self._deleted = 0             # live tombstone count
        self._dead_ids = set()        # ids tombstoned (idempotence)

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
        ivf._next_id = (int(np.max(row_ids)) + 1
                        if row_ids is not None and len(row_ids) else ivf._n)
        return ivf

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "DeviceIVFInt8":
        """An index from host arrays (``convert.ivf_state_from_jax``):
        the same layout, delta plane and tombstones, searched and
        mutated by the port."""
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
        if state["_dbuf"] is not None:
            ivf._dbuf = dev(state["_dbuf"])
            ivf._drmult = dev(state["_drmult"])
            ivf._dscale = dev(state["_dscale"])
            ivf._dids = np.array(state["_dids"], np.int64)
        # counters, tombstones, and the settings compact() rebuilds with
        for key in ("_kmeans_k", "_nprobe_cfg", "iters", "_n", "_next_id",
                    "_dn", "_deleted"):
            setattr(ivf, key, int(state[key]))
        ivf.max_read_frac = float(state["max_read_frac"])
        ivf._dead_ids = set(int(i) for i in state["_dead_ids"])
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
        self._next_id = n
        self._dbuf = self._drmult = self._dscale = self._dids = None
        self._dn = self._deleted = 0
        self._dead_ids = set()
        self._pos_of = None

    # ------------------------------------------------------------------
    # incremental mutation (IVFIndex::add, tensor_store/src/ivf.rs:276;
    # deletes are the tombstone side of the same contract). Adds cost
    # O(added): rows are quantized on the host and written into a delta
    # plane on the device whose capacity doubles. Every search scans the
    # delta exactly and merges it over the windowed hits, so an added
    # row is found at once. A delete zeroes the row's cosine multiplier
    # (the first passes score it -inf, and the rerank's first_scores
    # mask carries that on). compact() folds the delta back in.
    # ------------------------------------------------------------------
    _DELTA_MIN_CAP = 1024

    @staticmethod
    def _quant_rows(v: np.ndarray):
        """(int8 rows, scales, cosine multipliers) on the host, the JAX
        package's arithmetic (numpy, the same bits)."""
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        absmax = np.max(np.abs(v), axis=1)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
        sq = np.sum((q.astype(np.float32) * scale[:, None]) ** 2, axis=1)
        rm = np.where(sq > 0, scale / np.sqrt(np.maximum(sq, 1e-30)),
                      0.0).astype(np.float32)
        return q, scale, rm

    def _ensure_delta(self, extra: int) -> None:
        """Room for ``extra`` more delta rows: the capacity doubles from
        _DELTA_MIN_CAP, the old planes copied on the device."""
        need = self._dn + extra
        cap = 0 if self._dbuf is None else int(self._dbuf.shape[0])
        if need <= cap:
            return
        new_cap = max(self._DELTA_MIN_CAP, 1 << (need - 1).bit_length())
        dev = self.device
        db = torch.zeros((new_cap, self.dim), dtype=torch.int8, device=dev)
        drm = torch.zeros(new_cap, dtype=torch.float32, device=dev)
        dsc = torch.ones(new_cap, dtype=torch.float32, device=dev)
        dids = np.full(new_cap, -1, np.int64)
        if cap:
            db[:cap] = self._dbuf
            drm[:cap] = self._drmult
            dsc[:cap] = self._dscale
            dids[:cap] = self._dids
        self._dbuf, self._drmult, self._dscale = db, drm, dsc
        self._dids = dids

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows without rebuilding (ivf.rs:276 ``add``): O(added).
        Returns the new rows' ids (continuing the build numbering); they
        are found at once through the exact delta merge."""
        if self._buf is None:
            raise ValueError("build() first")
        q, scale, rm = self._quant_rows(vectors)
        m = q.shape[0]
        if q.shape[1] != self.dim:
            raise ValueError(f"dim {q.shape[1]} != index dim {self.dim}")
        self._ensure_delta(m)
        dn, dev = self._dn, self.device
        self._dbuf[dn:dn + m] = torch.from_numpy(q).to(dev)
        self._drmult[dn:dn + m] = torch.from_numpy(rm).to(dev)
        self._dscale[dn:dn + m] = torch.from_numpy(scale).to(dev)
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._dids[dn:dn + m] = ids
        self._dn += m
        self._next_id += m
        return ids

    def _main_pos_of(self, ids: np.ndarray) -> np.ndarray:
        """Sorted-buffer positions of original row ids (-1 = unknown)."""
        if self._pos_of is None:
            rid = np.asarray(self._row_ids, np.int64)
            inv = np.full(int(rid.max()) + 1 if rid.size else 0, -1,
                          np.int64)
            inv[rid] = np.arange(rid.size)
            self._pos_of = inv
        inv = self._pos_of
        ids = np.asarray(ids, np.int64)
        ok = (ids >= 0) & (ids < inv.shape[0])
        out = np.full(ids.shape, -1, np.int64)
        out[ok] = inv[ids[ok]]
        return out

    def delete(self, ids) -> int:
        """Tombstone rows by id: their cosine multiplier goes to 0, so
        every scan (both first passes, the delta scan, the rerank through
        its first_scores mask) treats them as invalid. Idempotent; no
        relayout. Returns the number tombstoned.

        The main plane's multipliers are replaced, not written in place:
        an index assembled by ``from_device_layout`` may share them with
        its caller."""
        if self._buf is None:
            raise ValueError("build() first")
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        ids = ids[[int(i) not in self._dead_ids for i in ids]]
        if ids.size == 0:
            return 0
        removed = 0
        pos = self._main_pos_of(ids)
        main = pos[pos >= 0]
        if main.size:
            self._rmult = self._rmult.index_fill(
                0, torch.from_numpy(main).to(self.device), 0.0)
            self._dead_ids.update(int(i) for i in ids[pos >= 0])
            removed += int(main.size)
        if self._dn:
            slots = np.flatnonzero(np.isin(self._dids[:self._dn], ids))
            if slots.size:
                self._dead_ids.update(int(i) for i in self._dids[slots])
                self._drmult[torch.from_numpy(slots).to(self.device)] = 0.0
                self._dids[slots] = -1
                removed += int(slots.size)
        self._deleted += removed
        return removed

    def _delta_topk(self, qd: torch.Tensor, k: int):
        """Exact f32 cosine top-k over the delta plane's filled slots;
        host (scores [Q, k'], original ids [Q, k'] with -inf / -1
        sentinels). The JAX package scans every slot of the plane, but a
        slot past ``_dn`` holds a zero multiplier (``_ensure_delta``), so
        it scores -inf and would be masked to -1 here: the merged hits
        are the same."""
        dn = self._dn
        s, pos = host_pull(*int8_exact_topk(self._dbuf[:dn],
                                            self._drmult[:dn], qd,
                                            min(k, dn)))
        ids = np.where(pos >= 0, self._dids[np.maximum(pos, 0)], -1)
        ids = np.where(np.isneginf(s) | (ids < 0), -1, ids)
        s = np.where(ids < 0, -np.inf, s)
        return s, ids.astype(np.int64)

    @staticmethod
    def _merge_topk(s1, ids1, s2, ids2, k: int):
        """The best k of two hit lists, on the host: a stable sort, so
        equal scores keep the windowed hits first, as in the JAX
        package."""
        s = np.concatenate([s1, s2], axis=1)
        ids = np.concatenate([np.asarray(ids1, np.int64),
                              np.asarray(ids2, np.int64)], axis=1)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        s = np.take_along_axis(s, order, axis=1)
        ids = np.take_along_axis(ids, order, axis=1)
        return s, np.where(np.isfinite(s), ids, -1)

    def compact(self, sample_rows: int = 200_000, seed: int = 0) -> int:
        """Fold the delta plane and the tombstones back into a fresh
        windowed layout: the planes come to the host, the live rows are
        rebuilt (O(N), amortized over >= 10 % growth). Row ids are
        preserved. The residual plane (if any) is dropped; rebuild with
        ``build(..., residual=...)`` to restore it. Returns the live row
        count."""
        if self._buf is None:
            raise ValueError("build() first")
        if self._scale is None:
            raise ValueError("compact() needs per-row scales; this index "
                             "was assembled from a device layout without "
                             "them")
        rm, buf, scale = host_pull(self._rmult, self._buf, self._scale)
        n0 = min(self._n, rm.shape[0])
        keep = np.flatnonzero(rm[:n0] > 0)
        bufs, scales = [buf[keep]], [scale[keep]]
        all_ids = [np.asarray(self._row_ids, np.int64)[keep]]
        if self._dn:
            drm, dbuf, dsc = host_pull(self._drmult[:self._dn],
                                       self._dbuf[:self._dn],
                                       self._dscale[:self._dn])
            dkeep = np.flatnonzero(drm > 0)
            if dkeep.size:
                bufs.append(dbuf[dkeep])
                scales.append(dsc[dkeep])
                all_ids.append(self._dids[dkeep])
        ids = np.concatenate(all_ids, axis=0)
        next_id = self._next_id
        self.build(np.concatenate(bufs, axis=0),
                   np.concatenate(scales, axis=0), sample_rows=sample_rows,
                   seed=seed,
                   fixed_window=self._window if self._fixed else None)
        # build() numbers rows 0..n-1 in corpus order; restore the
        # caller-visible ids through the sort permutation
        self._row_ids = ids[self._row_ids].astype(np.int64)
        self._pos_of = None
        self._next_id = next_id
        return int(ids.size)

    @property
    def n_live(self) -> int:
        return self._n + self._dn - self._deleted

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def _ids_of(self, pos: np.ndarray) -> np.ndarray:
        return np.where(pos >= 0,
                        np.asarray(self._row_ids)[np.maximum(pos, 0)], -1)

    def _with_delta(self, s, ids, qd: torch.Tensor, k: int):
        """Host hits with the delta plane's exact hits merged in."""
        if self._dn:
            s, ids = self._merge_topk(s, ids, *self._delta_topk(qd, k), k)
        return s, ids.astype(np.int32)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Latency path: probe kernel first pass (oversampled to 4k+16
        to cover window-overlap duplicates), exact f32 rerank (+residual
        plane when built), the delta plane merged in. Returns host
        (scores [Q, k], ids [Q, k] int32)."""
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
        return self._with_delta(s, self._ids_of(pos), qd, k)

    def batched_fast_ok(self, k: int) -> bool:
        """Whether ``search_batched`` takes the fast path by default (the
        predicate the JAX package inlines): disjoint fixed windows of a
        power-of-two number (>= 2) of 128-row pools, and k <= 128 (the
        packed-bits presel keeps at most 512 distinct candidates per
        query)."""
        pool = self._window // 128
        return (self._fixed and self._window % 128 == 0 and pool >= 2
                and (pool & (pool - 1)) == 0 and k <= 128)

    def default_q_cap(self, q_pad: int, nprobe: int) -> int:
        """Queries a window's table holds, to start with: 3x the uniform
        expectation rounded up to a multiple of 64 for batches above 64
        (realistic query skew, without a power of two's padding), else
        a power of two of at least 16."""
        expect = -(-q_pad * nprobe // self.n_clusters)
        if q_pad > 64:
            return max(64, -(-(3 * expect) // 64) * 64)
        return 1 << (max(16, 4 * expect) - 1).bit_length()

    def search_batched(self, queries: np.ndarray, k: int,
                       nprobe: Optional[int] = None,
                       m: Optional[int] = None,
                       q_cap: Optional[int] = None,
                       fast: Optional[bool] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Throughput path: probe-sharing batched first pass, then the
        chunked exact rerank (+residual plane when built), the delta
        plane merged in.

        fast (default ``batched_fast_ok(k)``): the batched top-2 kernel
        with pool-winner probes and a packed-bits preselection of
        O(3k) candidates. Otherwise the non-fast variant: exact probes,
        exact int8 dots of each probed window against its queries, the
        top-m of each (query, window) (m default min(k + 6, window)),
        then the best min(8k + 16, nprobe * m) candidates by first-pass
        score go to the rerank. Queries pad to power-of-two buckets;
        q_cap (queries per window) starts at ~3x the uniform expectation
        and doubles on overflow. Returns host (scores [Q, k], ids [Q, k]
        int32)."""
        if self._buf is None:
            raise ValueError("build() first")
        if fast is None:
            fast = self.batched_fast_ok(k)
        nprobe = min(nprobe or self.nprobe, self.n_clusters)
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nq = q.shape[0]
        q_pad = max(8, 1 << (nq - 1).bit_length())
        if q_pad != nq:
            q = np.concatenate(
                [q, np.zeros((q_pad - nq, q.shape[1]), np.float32)])
        if m is None:
            m = min(k + 6, self._window)
        if q_cap is None:
            q_cap = self.default_q_cap(q_pad, nprobe)
        qd = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        valid = torch.arange(q_pad, device=self.device) < nq
        if fast:
            sel, fused = self._window // 128, "pallas"
            pmode = "pool" if nprobe < self.n_clusters else "exact"
            # the top-2 kernel + packed-bits presel keep O(3k) candidates
            presel = min(max(3 * k + 2, 32), nprobe * 256)
        else:
            sel, fused, pmode, presel = "approx", False, "exact", 0
        while True:
            sc, pos, overflow = batched_ivf_topk(
                self._buf, self._rmult, self.centroids, self._starts, qd,
                nprobe, self._window, m, q_cap, valid_q=valid,
                selection=sel, fused=fused, probe_mode=pmode, presel=presel)
            if overflow == 0 or q_cap >= q_pad:
                break     # q_cap == q_pad can never overflow
            q_cap *= 2
        # the non-fast pass keeps nprobe * m candidates a query: cut them
        # to O(8k) by first-pass score before the rerank gathers rows
        # (+16 covers window-overlap duplicates)
        sc, pos = gather_rerank_topk_chunked(
            self._buf, pos, qd, k, "cosine", scale=self._scale,
            residual_q=self._rbuf, residual_scale=self._rscale,
            first_scores=sc, dedup=not self._fixed, chunk=min(128, q_pad),
            pre_select=None if fast else min(8 * k + 16, pos.shape[1]))
        s, p = host_pull(sc[:nq], pos[:nq])
        return self._with_delta(s, self._ids_of(p), qd[:nq], k)


# --------------------------------------------------------------------------
# Batched IVF: probe-sharing throughput pass (see the block comment in
# neumann_tpu/ops/ivf.py). Windows stream once per batch, each scored
# only against the queries that probed it: probe selection, per-window
# query tables, the first pass, then each query's candidates gathered
# back from its probes' table slots.
# --------------------------------------------------------------------------

def _probe_windows(qn, cents, nprobe: int, probe_mode: str):
    """[Q, nprobe] probed windows; C (sentinel) for dead pool picks.
    "exact": the top-nprobe centroid scores in ``lax.top_k``'s order;
    "approx" is the JAX package's ``approx_max_k`` of the same, exact
    here (torch has none; on the CPU the JAX one is exact too); "pool":
    one winner per strided pool of the score row."""
    n_c = cents.shape[0]
    if probe_mode not in ("pool", "exact", "approx"):
        raise ValueError(f"unknown probe_mode {probe_mode!r}")
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
    return _topk_stable(qn @ cents.T, nprobe)[1].int()


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


def _score_windows(buf, rmult, starts, tbl, qq_i8, qsc, window: int, m: int,
                   pool: int, from_view: bool):
    """The non-fused first pass (the JAX package's ``score_window``
    under its scan and fused variants): each probed window's rows against
    the int8 queries of its table, exact dots times the query scale and
    the row multiplier, then per (window, slot) either the top-m (``pool``
    0: ``kernels.ivf_window_topm``, the hand kernel on the card;
    ``approx_max_k`` in the JAX package, exact here, in ``lax.top_k``'s
    order) or, in plain torch, one pooled-bits winner per contiguous
    ``pool``-row pool (the XLA-fused form, which no entry point reaches).

    Only windows some query probed are scored (slots fill from 0, so
    tbl[c, 0] >= 0 marks one). Returns (ys_s [L, q_cap, m_eff] f32, ys_p
    [L, q_cap, m_eff] int32, for the L probed windows: -inf / -1 where
    dead in the pooled form, -inf at the dead rows' own positions in the
    top-m; the top-m leaves empty slots unwritten; slot_of [C], window c's
    index among them; m_eff = window // pool or m). from_view: window c's
    rows are rows c * window on (the stream and fused variants' reshaped
    view); otherwise the rows at starts[c], clamped into the buffer as
    ``lax.dynamic_slice`` clamps. Positions are starts[c] + offset either
    way. The pooled form goes in steps of at most
    ``kernels._WINDOW_STEP_BYTES``, a few dozen launches each."""
    n_c, q_cap = tbl.shape
    n, d = buf.shape
    dev = buf.device
    live = torch.nonzero(tbl[:, 0] >= 0).flatten()
    n_live = live.numel()
    slot_of = torch.zeros(n_c, dtype=torch.int64, device=dev)
    slot_of[live] = torch.arange(n_live, device=dev)
    base = starts[live].long()
    first = live * window if from_view else base.clamp(0, n - window)
    t = tbl[live]
    if not pool:
        ys_s, ys_p = kernels.ivf_window_topm(buf, rmult, first, base, t,
                                             qq_i8, qsc, window, m)
        return ys_s, ys_p, slot_of, m
    m_eff = window // pool
    tq = t.clamp_min(0)
    sc_slot = torch.where(t >= 0, qsc[tq], 0.0)
    span = torch.arange(window, device=dev)
    ys_s = torch.empty((n_live, q_cap, m_eff), device=dev)
    ys_p = torch.empty((n_live, q_cap, m_eff), dtype=torch.int32,
                       device=dev)
    step = _windows_per_step(window, q_cap, d)
    member = (span % pool).int()
    for i0 in range(0, n_live, step):
        i1 = min(n_live, i0 + step)
        idx = first[i0:i1, None] + span                       # [G, w]
        rm = rmult[idx][:, None, :]                           # [G, 1, w]
        dots = _int8_dots(qq_i8[tq[i0:i1]], buf[idx])         # [G, q, w]
        mult = sc_slot[i0:i1, :, None] * rm
        # pooled bits: scores shifted to [1, 3), the member index in the
        # low mantissa bits; the sum is one fused multiply-add, as XLA
        # computes it
        sp = torch.where(rm > 0, kernels._fma_f32(dots, mult, 2.0), 0.0)
        bits = (sp.view(torch.int32) & ~(pool - 1)) | member
        wb = bits.reshape(i1 - i0, q_cap, m_eff, pool).amax(dim=3)
        dead = wb < 0x3F800000                        # below bitcast(1.0)
        ys_s[i0:i1] = torch.where(
            dead, NEG_INF, (wb & ~(pool - 1)).view(torch.float32) - 2.0)
        pos = (base[i0:i1, None, None] + span[:m_eff] * pool
               + (wb & (pool - 1)))
        ys_p[i0:i1] = torch.where(dead, -1, pos)
    return ys_s, ys_p, slot_of, m_eff


def batched_ivf_topk(buf, rmult, cents, starts, qs, nprobe: int,
                     window: int, m: int, q_cap: int,
                     valid_q=None, selection="approx", stream: bool = False,
                     fused=False, probe_mode: str = "exact",
                     presel: int = 0):
    """Probe-sharing batched IVF candidate pass (the JAX package's
    ``batched_ivf_topk``: its signature but ``group``, its argument errors).

    buf/rmult/cents/starts: the DeviceIVFInt8 layout; qs [Q, d] f32
    queries; valid_q [Q] bool (False = padding query). selection:
    "approx" = the top-m of each (query, window); an int p = pooled bits,
    one winner per p-row pool (pair with ``gather_rerank_topk_chunked
    (expand_pool=p)`` for collision-exact recall; m is then ignored).
    stream: windows read as rows c * window of a fixed-window layout
    instead of at starts[c]. fused=True: the JAX package's batched XLA
    form, pooled selection over the fixed-window view (the same numbers
    as stream with that pool). fused="pallas": the batched kernel
    (``csrc/batched_probe.cu``) with 128 strided pools of window / 128
    rows (selection must be window // 128); presel > 0 runs it in top-2
    mode and keeps the ``presel`` best candidates a query straight from
    the packed bits, presel 0 its top-1 mode with every (probe, pool)
    winner decoded. probe_mode: "exact", "approx" (exact here) or
    "pool". The JAX package's ``group`` (windows a scan step) has no
    counterpart: the port's steps are sized by bytes
    (``_score_windows``).

    Returns (scores [Q, nprobe * m_eff] f32, or [Q, presel]; positions in
    sorted-buffer coordinates int32 with -1 sentinels; overflow: probes
    dropped because more than q_cap queries probed one window — retry
    with a bigger q_cap if nonzero). Candidates may repeat across
    overlapping windows; rerank with dedup=True."""
    pool = selection if isinstance(selection, int) else 0
    if pool and (window % pool or pool & (pool - 1)):
        raise ValueError(f"pool {pool} must be a power-of-two divisor "
                         f"of window {window}")
    if fused and not pool:
        raise ValueError("fused batched core requires pooled-bits "
                         "selection (selection=<pool int>)")
    if fused == "pallas" and pool * 128 != window:
        raise ValueError(
            f"pallas fused core uses 128 strided pools of window/128 "
            f"rows: selection must be {window // 128}, got {pool}")
    if presel and fused != "pallas":
        raise ValueError("packed-bits presel requires the pallas "
                         "fused core")
    Q, d = qs.shape
    n_c = cents.shape[0]
    nw = n_c * window
    if valid_q is None:
        valid_q = torch.ones(Q, dtype=torch.bool, device=qs.device)
    qn = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
    probe = _probe_windows(qn, cents, nprobe, probe_mode)
    probe = torch.where(valid_q[:, None], probe, torch.full_like(probe, n_c))
    tbl, rank_of, overflow = _query_tables(probe, n_c, q_cap)
    # the reciprocal form: the JAX package quantizes inside the jitted
    # _batched_core
    qq_i8, qsc = scalar_quantize(qn, form="reciprocal")
    probe = probe.long()
    ok = (probe < n_c) & (rank_of < q_cap)
    cg = probe.clamp(max=n_c - 1)
    rk = rank_of.clamp(max=q_cap - 1)
    if fused != "pallas":
        ys_s, ys_p, slot_of, m_eff = _score_windows(
            buf, rmult, starts, tbl, qq_i8, qsc, window, m, pool,
            from_view=bool(stream or fused))
        cw = slot_of[cg]
        out_s = torch.where(ok[:, :, None], ys_s[cw, rk], NEG_INF)
        out_p = torch.where(ok[:, :, None], ys_p[cw, rk], -1)
        return out_s.reshape(Q, -1), out_p.reshape(Q, -1), overflow

    tsafe = tbl.clamp_min(0)
    qsel = qq_i8[tsafe.reshape(-1)].reshape(n_c, q_cap, d)
    sc_slot = torch.where(tbl >= 0, qsc[tsafe], torch.zeros_like(qsc[tsafe]))
    wb = batched_probe(buf[:nw], rmult[:nw].reshape(n_c, window), qsel,
                       sc_slot, window, top2=bool(presel))
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
        # in lax.top_k's order: equal bits by lane, the rerank's
        # candidate order
        sv, si = _topk_stable(cand.view(torch.float32),
                              min(presel, 2 * lanes))
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
