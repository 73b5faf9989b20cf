"""Tensor-train decomposition of many rows at once, on the rows' device.

The batched counterpart of ``tensor_train.tt_decompose`` /
``tt_reconstruct`` (the JAX package decomposes one row at a time in
numpy float64) for the engine's ``QUANTIZATION tt`` route. Each row
makes the same successive-SVD sweep over the same grid, in float64, with
the same rank cut: ``s > max(s[0] * tol, 1e-12)``, capped at
``max_rank``, at least 1 (``tt_rank``). Cores are float32, as there.

Rows whose ranks so far agree share every matrix shape, so a sweep step
is one batched product per group of such rows ("rank profile"). The
singular values and left vectors of each ``[p, c]`` unfolding come from
``torch.linalg.svd`` of its Gram matrix on the smaller side (``[p, p]``
or ``[c, c]``; 16 x 16 at most at 768-d, where the unfoldings are 12 x
64, 48 x 16 and 64 x 4): cuSOLVER's batched Jacobi SVD takes matrices
of up to 32 x 32 only, and would loop row by row over a 12 x 64
unfolding. The Gram matrix squares the condition number; in float64 a
singular value at the cut (1e-3 of the largest by default) still comes
out within about 1e-10 relative. The carried remainder is
``U_r^T A`` (``diag(s) V^T`` without dividing by s), so the kept part
of every row is an exact projection of it.

SVD signs differ between LAPACK and cuSOLVER (and between this and
numpy's direct SVD): compare reconstructions, never cores.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.compress.tensor_train import TTConfig, _factorize

# rows decomposed per step of the sweep (bounds the float64 temporaries)
_CHUNK_ROWS = 1 << 16


def tt_rank(s: torch.Tensor, tol: float, max_rank: int) -> torch.Tensor:
    """Ranks [B] kept of singular values s [B, K] (descending): the
    count of ``s > max(s[:, 0] * tol, 1e-12)``, capped at ``max_rank``
    and at K, at least 1 (``tt_decompose``'s cut)."""
    cutoff = (s[:, :1] * tol).clamp_min(1e-12)
    r = (s > cutoff).sum(dim=1).clamp(max=min(max_rank, s.shape[1]))
    return r.clamp_min(1)


def _unfolding_svd(m: torch.Tensor):
    """(u [B, p, K], s [B, K], w [B, K, c]) of float64 matrices m
    [B, p, c], K = min(p, c), s descending, m = u @ w and w = u^T m
    (``diag(s) V^T``), from the SVD of the smaller Gram matrix."""
    p, c = m.shape[1:]
    if p <= c:
        uu, ss, _ = torch.linalg.svd(m @ m.transpose(1, 2))
        return uu, ss.sqrt(), uu.transpose(1, 2) @ m
    vv, ss, _ = torch.linalg.svd(m.transpose(1, 2) @ m)
    s = ss.sqrt()
    u = m @ vv
    u = torch.where(s[:, None, :] > 0, u / s.clamp_min(1e-300)[:, None, :],
                    torch.zeros_like(u))
    return u, s, (vv * s[:, None, :]).transpose(1, 2)


@dataclass
class TTGroup:
    """Rows (``rows``: their positions in the decomposed batch) that
    share one rank profile, and their cores: ``cores[i]`` is
    [len(rows), r_{i-1}, grid[i], r_i] float32, r_0 = r_n = 1."""

    rows: torch.Tensor
    cores: List[torch.Tensor] = field(default_factory=list)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(c.shape[3] for c in self.cores[:-1])


@dataclass
class TTBatch:
    """The TT form of n rows of width dim, grouped by rank profile."""

    dim: int
    n: int
    grid: List[int]
    groups: List[TTGroup]

    @property
    def n_params(self) -> int:
        return sum(c[0].numel() * len(g.rows) if len(g.rows) else 0
                   for g in self.groups for c in g.cores)

    def compression_ratio(self) -> float:
        return self.n * self.dim / max(self.n_params, 1)

    def reconstruct(self) -> torch.Tensor:
        """[n, dim] float32 on the cores' device: ``tt_reconstruct`` of
        every row, in row order (each step an f32 contraction)."""
        out = None
        for g in self.groups:
            x = g.cores[0][:, 0]                        # [b, g0, r1]
            for core in g.cores[1:]:
                x = torch.einsum("bgr,brhs->bghs", x, core)
                x = x.reshape(x.shape[0], -1, x.shape[3])
            x = x.reshape(x.shape[0], self.dim)
            if out is None:
                out = x.new_empty((self.n, self.dim))
            out[g.rows] = x
        if out is None:
            out = torch.empty((0, self.dim))
        return out


def _sweep(v: torch.Tensor, grid: List[int], tol: float, max_rank: int
           ) -> Dict[Tuple[int, ...], TTGroup]:
    """One chunk of rows [b, dim] float64 -> groups by rank profile."""
    rows = torch.arange(v.shape[0], device=v.device)
    live = [(rows, v.reshape(v.shape[0], 1, -1), [], ())]
    for g in grid[:-1]:
        nxt = []
        for pos, rest, cores, prof in live:
            b, r_prev = rest.shape[0], rest.shape[1]
            u, s, w = _unfolding_svd(rest.reshape(b, r_prev * g, -1))
            r = tt_rank(s, tol, max_rank)
            for rv in torch.unique(r).tolist():
                sel = (r == rv).nonzero().squeeze(1)
                core = u[sel, :, :rv].reshape(-1, r_prev, g, rv).float()
                nxt.append((pos[sel], w[sel, :rv, :],
                            [c[sel] for c in cores] + [core], prof + (rv,)))
        live = nxt
    out = {}
    for pos, rest, cores, prof in live:
        last = rest.reshape(rest.shape[0], rest.shape[1], grid[-1], 1)
        out[prof] = TTGroup(pos, cores + [last.float()])
    return out


def tt_decompose_batch(rows: torch.Tensor, config: Optional[TTConfig] = None,
                       chunk_rows: int = _CHUNK_ROWS) -> TTBatch:
    """TT decomposition of every row of rows [n, dim] on its device
    (``tt_decompose`` per row, batched; see the module docstring)."""
    n, dim = rows.shape
    cfg = config or TTConfig.for_dim(dim)
    grid = list(cfg.grid)
    if int(np.prod(grid)) != dim:
        grid = _factorize(dim)
    merged: Dict[Tuple[int, ...], List[TTGroup]] = {}
    for r0 in range(0, n, chunk_rows):
        part = rows[r0:r0 + chunk_rows].double()
        for prof, grp in _sweep(part, grid, cfg.tol, cfg.max_rank).items():
            grp.rows = grp.rows + r0
            merged.setdefault(prof, []).append(grp)
    groups = []
    for parts in merged.values():
        groups.append(TTGroup(
            torch.cat([p.rows for p in parts]),
            [torch.cat([p.cores[i] for p in parts])
             for i in range(len(parts[0].cores))]))
    return TTBatch(dim, n, grid, groups)
