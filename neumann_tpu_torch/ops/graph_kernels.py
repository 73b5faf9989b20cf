"""Graph analytics over edge lists, in plain torch (port of
``neumann_tpu/ops/graph_kernels.py``).

The JAX package runs each function as XLA segment reductions inside a
``lax.while_loop`` / ``fori_loop``. Here each is a host loop over
torch scatter reductions on the edge tensors' device: frontier
expansion (``bfs_levels``), rank propagation (``pagerank``) and min-label
propagation (``connected_components``). No hand kernel: none of these
reaches ``pl.pallas_call`` in the JAX package, and a hand kernel comes
only once the card shows one holding a route (ROADMAP §2 a).

Edge endpoints are int64 tensors (torch's scatter ops index with int64;
the JAX package keeps int32). ``n`` is the padded node capacity and
``valid`` a bool [n] mask. ``pagerank`` adds floats with ``index_add_``,
whose order on CUDA is not fixed, so its result matches the JAX
package's within a tolerance; levels and labels are integers and match
exactly.
"""

from __future__ import annotations

import torch


def bfs_levels(src: torch.Tensor, dst: torch.Tensor, n: int,
               start: torch.Tensor, max_depth: int = 0) -> torch.Tensor:
    """Multi-source BFS levels. Returns int32[n], -1 = unreachable.

    src/dst: edge endpoints (directed; pass both directions for
    undirected). start: bool [n] mask of source nodes. max_depth 0 means
    unbounded (n levels worst case). One host sync per level, on
    whether the frontier grew.
    """
    limit = max_depth if max_depth > 0 else n
    start = start.to(torch.bool)
    levels = torch.where(start, 0, -1).to(torch.int32)
    frontier = start
    depth = 0
    while depth < limit:
        # a dst is reachable next if any src of its in-edges is in the
        # frontier
        hit = torch.zeros(n, dtype=torch.int32, device=src.device)
        hit.scatter_reduce_(0, dst, frontier[src].to(torch.int32), "amax",
                            include_self=True)
        frontier = (hit > 0) & (levels < 0)
        levels = torch.where(frontier, depth + 1, levels).to(torch.int32)
        depth += 1
        if not bool(frontier.any()):
            break
    return levels


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int,
             valid: torch.Tensor, damping: float = 0.85,
             iters: int = 20) -> torch.Tensor:
    """PageRank over the edge list; dangling mass redistributed
    uniformly. float32 [n], 0 on invalid slots."""
    dev = src.device
    nv = max(float(valid.sum()), 1.0)
    out_deg = torch.zeros(n, dtype=torch.float32, device=dev)
    out_deg.index_add_(0, src, torch.ones(src.shape[0], dtype=torch.float32,
                                          device=dev))
    rank = torch.where(valid, 1.0 / nv, 0.0).to(torch.float32)
    has_out = out_deg > 0
    deg = torch.clamp(out_deg, min=1.0)
    dangling_rows = ~has_out & valid
    for _ in range(iters):
        contrib = torch.where(has_out, rank / deg, 0.0)
        incoming = torch.zeros(n, dtype=torch.float32, device=dev)
        incoming.index_add_(0, dst, contrib[src])
        dangling = torch.where(dangling_rows, rank, 0.0).sum()
        new = (1.0 - damping) / nv + damping * (incoming + dangling / nv)
        rank = torch.where(valid, new, 0.0)
    return rank


def connected_components(src: torch.Tensor, dst: torch.Tensor, n: int,
                         valid: torch.Tensor) -> torch.Tensor:
    """Label propagation: every node converges to the min node id of its
    (weakly) connected component; -1 on invalid slots. Pass both edge
    directions. One host sync per round, on whether a label moved."""
    idx = torch.arange(n, dtype=torch.int64, device=src.device)
    labels = torch.where(valid, idx, n)
    while True:
        new = labels.scatter_reduce(0, dst, labels[src], "amin",
                                    include_self=True)
        new = torch.where(valid, new, n)
        if not bool((new != labels).any()):
            break
        labels = new
    return torch.where(valid, labels, -1).to(torch.int32)


def degree_counts(src: torch.Tensor, n: int) -> torch.Tensor:
    """Out-degree of every slot, int32 [n]."""
    return torch.bincount(src, minlength=n).to(torch.int32)
