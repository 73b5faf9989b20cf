"""Sharded top-k search over a mesh: a top-k on every shard, then one
merge (port of ``neumann_tpu/parallel/sharded_search.py``).

``ShardedCorpus`` keeps a corpus row-sharded over the mesh (f32, or int8
with per-row scales), each shard's tensors on its mesh device;
``ShardedIVFCorpus`` deals k-means clusters over the shards, each shard
holding its clusters' rows in the fixed-window int8 layout of
``ops/ivf.DeviceIVFInt8``. Every shard searches only its rows, and the
merge (``_merge_gathered``) takes the global top-k of the shards' [Q, k]
candidates, as JAX's all-gather over ICI does.

One process drives the mesh (``parallel/mesh.py``): where JAX runs one
program on every device under ``shard_map``, the port loops over the
shards, launching each one's work on its device. The "all-gather" is a
copy of each shard's [Q, k] scores and global ids to the mesh's first
device, concatenated in shard order; its top-k keeps ``lax.top_k``'s
order (``ops/scan._topk_stable``), and ids whose score is -inf become
-1. ``ShardedCorpus.search`` and ``ShardedIVFCorpus.search`` launch
every shard's work before the one host sync of the result, so shards on
separate cards overlap. On one card (logical devices,
``NEUMANN_MESH_DEVICES``) the shards run one after another on one
stream, and the copies stay on the card. ``search_batched`` syncs once a
shard (``batched_ivf_topk`` returns its overflow count to the host, as
``DeviceIVFInt8.search_batched`` reads it).

Shard-local kernels: the quantized ``ShardedCorpus`` takes the int8
pooled-bits scan (``int8_pooled_bits``, kernel 5) for cosine where a
pooled layout fits, else the int8 scan (``int8_dot_scores``, kernel 4),
then an exact f32 rerank; ``search_batched``'s fast form launches the
batched probe in its top-2 mode (``batched_probe``, kernel 2). The f32
``ShardedCorpus`` (``ops/scan.topk_scan``) and ``ShardedIVFCorpus.
search`` are plain torch, as their JAX code is XLA's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops.ivf import batched_ivf_topk
from neumann_tpu_torch.ops.quant import (
    _pick_pool,
    _row_multiplier,
    corpus_sqnorms,
    int8_pooled_topk,
    int8_topk_scan,
    scalar_quantize,
)
from neumann_tpu_torch.ops.rerank import (
    gather_rerank_topk,
    gather_rerank_topk_chunked,
)
from neumann_tpu_torch.ops.scan import (
    NEG_INF,
    _topk_stable,
    host_pull,
    topk_scan,
)
from neumann_tpu_torch.parallel.mesh import Mesh
from neumann_tpu_torch.utils.shapes import round_up

# bytes one step of ShardedIVFCorpus.search may gather: the probed int8
# windows of a chunk of queries and their f32 copy
_GATHER_BYTES = 1 << 30
# rows the assignment of ShardedIVFCorpus.load scores at a time
_ASSIGN_ROWS = 1 << 16


def _merge_gathered(scores, ids, k: int, device):
    """The shards' [Q, k] candidates (lists in shard order) copied to
    ``device`` and cut to the global top-k: (scores [Q, k], ids [Q, k]
    int64, -1 where the score is -inf)."""
    all_s = torch.stack([s.to(device) for s in scores], dim=1)  # [Q, S, k]
    all_i = torch.stack([i.to(device) for i in ids], dim=1)
    q = all_s.shape[0]
    all_s, all_i = all_s.reshape(q, -1), all_i.reshape(q, -1)
    ms, pos = _topk_stable(all_s, min(k, all_s.shape[1]))
    mi = torch.gather(all_i, 1, pos)
    return ms, mi.masked_fill(torch.isneginf(ms), -1)


def _global_ids(i: torch.Tensor, shard: int, rows: int) -> torch.Tensor:
    """Shard-local row ids -> global ids (-1 stays -1)."""
    i = i.long()
    return torch.where(i >= 0, i + shard * rows, -1)


def shard_rows(n: int, shards: int, quantized: bool) -> int:
    """The rows each shard of ``ShardedCorpus.load`` holds for n rows:
    n padded up to a multiple of (256 quantized, so that the pooled-bits
    layout applies, else 8) x shards, split evenly."""
    align = (256 if quantized else 8) * shards
    return round_up(max(n, 1), align) // shards


def shard_pool(rows: int, k: int, metric: str) -> Optional[int]:
    """The pool of a quantized shard's pooled-bits scan at top-k, or None
    where the shard takes the int8 scan: cosine, a pooled layout for its
    c = min(max(4k, 32), rows) rerank candidates, and at least 4c pools
    (pooled selection returns at most one row per pool)."""
    c = min(max(4 * k, 32), rows)
    pool_cap = min(4096, max(8, rows // (4 * c)))
    pool = _pick_pool(rows, c, pool_cap) if metric == "cosine" else None
    return pool if pool and rows // pool >= 4 * c else None


def make_sharded_topk(mesh: Mesh, k: int, metric: str = "cosine",
                      axis: str = "shard", quantized: bool = False,
                      block_rows: int = 256 * 1024):
    """A sharded search function for the given mesh.

    Returns fn(corpus, queries, mask) -> (scores [Q, k], global ids [Q,
    k]) on the mesh's first device, where corpus and mask are sequences
    of shard tensors ([rows, d] and [rows] bool, shard i on the i-th
    device along ``axis``) and queries [Q, d] f32 (copied to each
    shard's device). The int8 variant is fn(corpus, scale, sqnorm,
    queries, mask), with scale and sqnorm sharded like mask.

    Quantized shards run two-pass: the int8 scan selects shard-local
    candidates, a shard-local exact f32 rerank rescores them against the
    unquantized query (``ops/rerank.gather_rerank_topk``), and only then
    do k exact-scored candidates per shard reach the merge."""
    devices = mesh.axis_devices(axis)

    def local(corpus, queries, mask, scale=None, sqnorm=None):
        rows = corpus.shape[0]
        if not quantized:
            return topk_scan(corpus, queries, k, metric, mask,
                             block_rows=block_rows)
        c = min(max(4 * k, 32), rows)    # local rerank candidates
        pool = shard_pool(rows, k, metric)
        if pool:
            rm = _row_multiplier(scale, sqnorm, "cosine")
            s, i = int8_pooled_topk(corpus, scale, queries, c, pool=pool,
                                    mask=mask, row_mult=rm)
        else:
            s, i = int8_topk_scan(corpus, scale, queries, c, metric, mask,
                                  block_rows=block_rows,
                                  corpus_sqnorm=sqnorm)
        return gather_rerank_topk(corpus, i, queries, k, metric, scale,
                                  first_scores=s, dedup=False)

    def fn(*args):
        if quantized:
            corpus, scale, sqnorm, queries, mask = args
        else:
            corpus, queries, mask = args
            scale = sqnorm = [None] * len(devices)
        parts_s, parts_i = [], []
        for shard, dev in enumerate(devices):
            s, i = local(corpus[shard], queries.to(dev), mask[shard],
                         scale[shard], sqnorm[shard])
            parts_s.append(s)
            parts_i.append(_global_ids(i, shard, corpus[shard].shape[0]))
        return _merge_gathered(parts_s, parts_i, k, devices[0])

    return fn


def _split(t: torch.Tensor, devices):
    """Equal row blocks of ``t``, block i on devices[i]."""
    per = t.shape[0] // len(devices)
    return [t[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]


class ShardedCorpus:
    """A corpus row-sharded over a mesh with a search method.

    Rows pad up to a multiple of (lane x n_shards); the validity mask
    carries both padding and tombstones, fused into every scan.
    """

    def __init__(self, mesh: Mesh, dim: int, axis: str = "shard",
                 quantized: bool = False):
        self.mesh = mesh
        self.axis = axis
        self.dim = dim
        self.dim_pad = round_up(dim, 128)
        self.quantized = quantized
        self.n_shards = mesh.shape[axis]
        self.devices = mesh.axis_devices(axis)
        self._fns = {}
        self.corpus = None      # [n_shards] shard tensors
        self.scale = None
        self.sqnorm = None
        self.mask = None
        self._mask_host = None
        self.n_rows = 0

    def load(self, vectors: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        """Distribute [N, d] host vectors across the mesh, shard by
        shard (no host copy of the whole padded corpus)."""
        n, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"dim mismatch {d} != {self.dim}")
        # padding rows are masked out
        per = shard_rows(n, self.n_shards, self.quantized)
        rows = per * self.n_shards
        m = np.zeros(rows, bool)
        m[:n] = True if mask is None else mask
        self.corpus, self.scale, self.sqnorm = [], [], []
        for shard, dev in enumerate(self.devices):
            r0 = shard * per
            part = np.ascontiguousarray(vectors[r0:min(n, r0 + per)],
                                        np.float32)
            buf = torch.zeros((per, self.dim_pad), device=dev)
            buf[:len(part), :d] = torch.from_numpy(part).to(dev)
            if self.quantized:
                q, scale = scalar_quantize(buf)
                del buf
                self.corpus.append(q)
                self.scale.append(scale)
                self.sqnorm.append(corpus_sqnorms(q, scale))
            else:
                self.corpus.append(buf)
        self._mask_host = m
        self.mask = _split(torch.from_numpy(m), self.devices)
        self.n_rows = n

    def search(self, queries: np.ndarray, k: int,
               metric: str = "cosine",
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``mask`` (host [n_rows] bool) narrows this call to matching
        rows — the engine's metadata filters fused into the sharded
        scan, like the single-device path."""
        if self.corpus is None:
            raise ValueError("corpus not loaded")
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        qp = np.zeros((q.shape[0], self.dim_pad), np.float32)
        qp[:, : self.dim] = q
        key = (k, metric)
        fn = self._fns.get(key)
        if fn is None:
            fn = make_sharded_topk(self.mesh, k, metric, self.axis,
                                   self.quantized)
            self._fns[key] = fn
        m = self.mask
        if mask is not None:
            rows = len(self._mask_host)
            mm = np.zeros(rows, bool)
            mm[: min(rows, len(mask))] = mask[:rows]
            mm &= self._mask_host
            m = _split(torch.from_numpy(mm), self.devices)
        qd = torch.from_numpy(qp)
        if self.quantized:
            s, i = fn(self.corpus, self.scale, self.sqnorm, qd, m)
        else:
            s, i = fn(self.corpus, qd, m)
        s, i = host_pull(s, i)
        return s, i.astype(np.int32)


# ---------------------------------------------------------------------------
# sharded windowed IVF: the single-query latency path over the mesh
# ---------------------------------------------------------------------------

class ShardedIVFCorpus:
    """Cluster-sharded windowed IVF over a device mesh.

    The mesh analog of ops.ivf.DeviceIVFInt8: k-means clusters are dealt
    across shards (biggest first, each to the least loaded shard), each
    shard holds its clusters' rows in a windowed cluster-sorted int8
    layout, and a query probes its ``nprobe`` best windows on every
    shard before one merge of the [Q, k] candidates.

    The layout follows the JAX class step for step; its host steps (the
    assignment, the quantization, the window means) run in torch on the
    mesh's first device, and each shard's planes then move to its own.
    """

    def __init__(self, mesh: Mesh, dim: int, axis: str = "shard",
                 n_clusters: int = 64, nprobe: int = 8,
                 iters: int = 8):
        self.mesh = mesh
        self.axis = axis
        self.dim = dim
        self.dim_pad = round_up(dim, 128)
        self.n_shards = mesh.shape[axis]
        self.devices = mesh.axis_devices(axis)
        self.n_clusters = max(self.n_shards,
                              (n_clusters // self.n_shards)
                              * self.n_shards)
        self.nprobe = nprobe
        self._nprobe_cfg = nprobe     # cluster-unit config (see load)
        self.iters = iters
        self.corpus = None

    def load(self, vectors: np.ndarray, seed: int = 0) -> None:
        from neumann_tpu_torch.parallel.partitioner import kmeans

        v = np.asarray(vectors, np.float32)
        n, d = v.shape
        if d != self.dim:
            raise ValueError(f"dim mismatch {d} != {self.dim}")
        dev = self.devices[0]
        S, C = self.n_shards, self.n_clusters
        vp = torch.zeros((n, self.dim_pad), device=dev)
        vp[:, :d] = torch.from_numpy(v).to(dev)
        rng = np.random.default_rng(seed)
        pick = rng.choice(n, size=min(50_000, n), replace=False)
        cents = torch.from_numpy(kmeans(
            vp[torch.from_numpy(pick).to(dev)], C, self.iters,
            device=dev)).to(dev)
        cents = cents / cents.norm(dim=1, keepdim=True).clamp_min(1e-30)
        vn = vp / vp.norm(dim=1, keepdim=True).clamp_min(1e-30)
        assign = torch.cat([
            (vn[r0:r0 + _ASSIGN_ROWS] @ cents.T).argmax(dim=1)
            for r0 in range(0, n, _ASSIGN_ROWS)]).cpu().numpy()
        counts = np.bincount(assign, minlength=C)

        # balance: biggest clusters deal round-robin across shards
        order_c = np.argsort(-counts, kind="stable")
        shard_clusters = [[] for _ in range(S)]
        loads = np.zeros(S, np.int64)
        for c in order_c:
            s = int(np.argmin(loads))
            shard_clusters[s].append(int(c))
            loads[s] += counts[c]

        # per-shard FIXED-window layout (ops/ivf.py DeviceIVFInt8):
        # each shard's rows cluster-sorted, then chopped into disjoint
        # `window`-row windows probed by their normalized mean rows, so
        # candidates are distinct by construction
        avg = max(1, n // max(1, C))
        window = int(min(1024, max(128, -(-avg // 128) * 128)))
        max_shard_rows = max(
            int(counts[cs].sum()) for cs in shard_clusters)
        rows_s = max(window, -(-max_shard_rows // window) * window)
        c_per = rows_s // window          # probe domain: windows/shard
        q8, scale = scalar_quantize(vp)
        sq = (vp * vp).sum(dim=1)
        del vp
        # combined multiplier scale / ||x||: an int8 row times it is the
        # unit row up to the int8 rounding
        rmult_all = torch.where(
            sq > 0, 1.0 / torch.sqrt(sq.clamp_min(1e-30)), 0.0) * scale
        order_by_cluster = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order_by_cluster],
                                 np.arange(C + 1))
        self.corpus, self.rmult, self.cents, self.starts = [], [], [], []
        row_ids = np.full((S, rows_s), -1, np.int64)
        starts = torch.arange(c_per, dtype=torch.int32) * window
        for s, sdev in enumerate(self.devices):
            rows = (np.concatenate(
                [order_by_cluster[bounds[c]: bounds[c + 1]]
                 for c in shard_clusters[s]])
                if shard_clusters[s] else np.empty(0, np.int64))
            n_s = len(rows)
            rt = torch.from_numpy(rows).to(dev)
            buf = torch.zeros((rows_s, self.dim_pad), dtype=torch.int8,
                              device=dev)
            buf[:n_s] = q8[rt]
            rmult = torch.zeros(rows_s, device=dev)
            rmult[:n_s] = rmult_all[rt]
            row_ids[s, :n_s] = rows
            # window-mean probe centroids over the shard's unit rows
            unit = torch.zeros((rows_s, self.dim_pad), device=dev)
            unit[:n_s] = vn[rt]
            sums = unit.reshape(c_per, window, self.dim_pad).sum(dim=1)
            del unit
            norms = sums.norm(dim=1, keepdim=True)
            self.cents.append(torch.where(
                norms > 0, sums / norms.clamp_min(1e-30), 0.0).to(sdev))
            self.corpus.append(buf.to(sdev))
            self.rmult.append(rmult.to(sdev))
            self.starts.append(starts.to(sdev))
        self.row_ids = row_ids
        self.rows_s = rows_s
        self.window = window
        self.c_per = c_per
        self.n_rows = n
        # recalibrate nprobe from cluster units to window units so the
        # configured READ FRACTION survives the fixed-window layout
        # (mirrors DeviceIVFInt8.build): "probe 8 of 64 clusters" meant
        # ~8 * (n/64) rows per shard, i.e. 8 * avg/window windows
        self.nprobe = int(max(1, min(
            c_per,
            -(-self._nprobe_cfg * max(1, n // max(1, C)) // window))))

    def _queries(self, queries: np.ndarray) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        return q[None, :] if q.ndim == 1 else q

    def _search_shard(self, shard: int, qn: torch.Tensor, k: int):
        """One shard's exact-scored top-k: (scores [Q, k'], global
        positions [Q, k'], -1 where -inf), k' = min(k, kk).

        The probe is the top-nprobe of qn @ cents.T; the first pass
        scores every row of the probed windows in JAX's numerics (the
        query rounded to bf16, the int8 rows exact, products exact and
        summed in f32) and keeps the top kk = min(4k + 16, window *
        nprobe); the rerank rescores those exactly in f32 (an int8 row
        times its multiplier is the unit row). Windows are disjoint, so
        the candidates are distinct. Queries go in chunks whose gathered
        windows stay under _GATHER_BYTES."""
        buf, rm = self.corpus[shard], self.rmult[shard]
        window, d = self.window, buf.shape[1]
        nprobe = min(self.nprobe, self.c_per)
        kk = min(4 * k + 16, window * nprobe)
        probe = _topk_stable(qn @ self.cents[shard].T, nprobe)[1]
        base = self.starts[shard][probe].long()               # [Q, nprobe]
        span = torch.arange(window, device=buf.device)
        qb = qn.to(torch.bfloat16).float()
        chunk = max(1, _GATHER_BYTES // (5 * nprobe * window * d))
        parts_s, parts_p = [], []
        for q0 in range(0, qn.shape[0], chunk):
            pos = (base[q0:q0 + chunk, :, None] + span).flatten(1)
            dots = torch.bmm(buf[pos].float(),
                             qb[q0:q0 + chunk, :, None])[..., 0]
            rr = rm[pos]
            scores = torch.where(rr > 0, dots * rr, NEG_INF)
            s, i = _topk_stable(scores, kk)
            pos = torch.gather(pos, 1, i)
            cand = buf[pos].float() * rm[pos][:, :, None]     # [c, kk, d]
            ex = torch.einsum("qd,qkd->qk", qn[q0:q0 + chunk], cand)
            ex = ex.masked_fill(torch.isneginf(s), NEG_INF)
            s_k, sel = _topk_stable(ex, min(k, kk))
            pos_k = torch.gather(pos, 1, sel) + shard * self.rows_s
            parts_s.append(s_k)
            parts_p.append(pos_k.masked_fill(torch.isneginf(s_k), -1))
        return torch.cat(parts_s), torch.cat(parts_p)

    def _host_ids(self, s: np.ndarray, gpos: np.ndarray):
        """Global positions -> ORIGINAL row ids (-1 for padding slots and
        -inf scores); scores -inf where the id is -1."""
        flat_ids = self.row_ids.reshape(-1)
        ids = np.where(gpos >= 0, flat_ids[np.maximum(gpos, 0)], -1)
        ids = np.where(np.isfinite(s), ids, -1)
        return np.where(ids >= 0, s, -np.inf).astype(np.float32), ids

    def search_batched(self, queries: np.ndarray, k: int,
                       fast: Optional[bool] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Throughput search over the mesh: batched probe-sharing per
        shard (``ops/ivf.batched_ivf_topk``) + exact shard rerank +
        merge. Same results contract as search(); q_cap doubles on
        overflow (the overflow summed over the shards) like the
        single-device DeviceIVFInt8.search_batched.

        fast (default: on a CUDA mesh, for windows of a power-of-two
        number >= 2 of 128-row pools and k <= 128): the batched top-2
        kernel (kernel 2) with pool-winner probes and a packed-bits
        preselection; otherwise the plain-torch first pass."""
        if self.corpus is None:
            raise ValueError("load() first")
        q = self._queries(queries)
        nq = q.shape[0]
        q_pad = max(8, 1 << (nq - 1).bit_length())
        qp = np.zeros((q_pad, self.dim_pad), np.float32)
        qp[:nq, : self.dim] = q[:, : self.dim]
        nprobe = min(self.nprobe, self.c_per)
        window = self.window
        pool = window // 128
        if fast is None:
            fast = (self.devices[0].type == "cuda" and window % 128 == 0
                    and pool >= 2 and (pool & (pool - 1)) == 0
                    and k <= 128)
        expect = -(-q_pad * nprobe // max(1, self.c_per))
        q_cap = (max(64, -(-(3 * expect) // 64) * 64) if q_pad > 64
                 else (1 << (max(16, 4 * expect) - 1).bit_length()))
        m = min(k + 6, window)
        presel = min(max(3 * k + 2, 32), nprobe * 256) if fast else 0
        qd = torch.from_numpy(qp)
        while True:
            parts_s, parts_p, overflow = [], [], 0
            for shard, dev in enumerate(self.devices):
                qs = qd.to(dev)
                qn = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
                layout = (self.corpus[shard], self.rmult[shard],
                          self.cents[shard], self.starts[shard], qn,
                          nprobe, window, m, q_cap)
                if fast:
                    sc, pos, ovf = batched_ivf_topk(
                        *layout, selection=pool, fused="pallas",
                        probe_mode=("pool" if nprobe < self.c_per
                                    else "exact"), presel=presel)
                else:
                    sc, pos, ovf = batched_ivf_topk(*layout)
                # disjoint fixed windows -> no dedup; the fast core's
                # candidates are already its presel survivors
                s_k, pos_k = gather_rerank_topk_chunked(
                    self.corpus[shard], pos, qn, k, "cosine",
                    first_scores=sc, dedup=False, chunk=min(128, q_pad),
                    pre_select=None if fast
                    else min(8 * k + 16, pos.shape[1]),
                    row_mult=self.rmult[shard])
                parts_s.append(s_k)
                parts_p.append(_global_ids(pos_k, shard, self.rows_s))
                overflow += ovf
            s, gpos = _merge_gathered(parts_s, parts_p, k, self.devices[0])
            if overflow == 0 or q_cap >= q_pad:
                break
            q_cap *= 2
        s, gpos = host_pull(s, gpos)
        s, ids = self._host_ids(s[:nq], gpos[:nq])
        return s, ids.astype(np.int64)

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], ORIGINAL row ids [Q, k], -1 sentinels)."""
        if self.corpus is None:
            raise ValueError("load() first")
        q = self._queries(queries)
        qp = np.zeros((q.shape[0], self.dim_pad), np.float32)
        qp[:, : self.dim] = q
        qd = torch.from_numpy(qp)
        parts_s, parts_p = [], []
        for shard, dev in enumerate(self.devices):
            qs = qd.to(dev)
            qn = qs / qs.norm(dim=1, keepdim=True).clamp_min(1e-30)
            s, p = self._search_shard(shard, qn, k)
            parts_s.append(s)
            parts_p.append(p)
        s, gpos = _merge_gathered(parts_s, parts_p, parts_s[0].shape[1],
                                  self.devices[0])
        s, gpos = host_pull(s, gpos)
        # positions are DISTINCT by construction (disjoint windows,
        # disjoint shard bases) and each original row lives in one
        # shard slot, so no dedup; padding slots map to id -1
        sm, ids = self._host_ids(s, gpos)
        order = np.argsort(-sm, axis=1, kind="stable")[:, :k]
        out_s = np.take_along_axis(sm, order, axis=1)
        out_i = np.take_along_axis(ids, order, axis=1).astype(np.int64)
        if out_s.shape[1] < k:          # fewer candidates than k
            pad = k - out_s.shape[1]
            out_s = np.pad(out_s, ((0, 0), (0, pad)),
                           constant_values=-np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, pad)),
                           constant_values=-1)
        return out_s, out_i
