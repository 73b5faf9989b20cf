"""Centrality and community algorithms (mixin for GraphEngine).

Copy of ``neumann_tpu.engines.graph_algorithms``; eigenvector centrality
runs its power iteration with torch on the engine's device instead of a
jitted JAX step. Everything else is unchanged host code.

Parity with the reference's graph algorithm surface (query-language.md:
PAGERANK/BETWEENNESS/CLOSENESS/EIGENVECTOR/LOUVAIN/LABEL_PROPAGATION and
graph_engine/src/algorithms/). Eigenvector centrality runs as device
power iteration over the edge list (index_add_); Brandes betweenness and
Louvain are host algorithms over the adjacency cache (sampled sources for
betweenness, like the reference's SAMPLING_RATIO).
"""

from __future__ import annotations

import random
from collections import deque
from typing import Dict, List, Optional

import numpy as np


class GraphAlgorithmsMixin:
    """Mixed into GraphEngine; relies on _nodes/_neighbor_ids/_edge_arrays."""

    def betweenness_centrality(self, sampling_ratio: float = 1.0,
                               direction: str = "both",
                               seed: int = 0) -> Dict[int, float]:
        """Brandes' algorithm; sources sampled by sampling_ratio."""
        with self._lock:
            nodes = sorted(self._nodes)
            adj = {n: self._neighbor_ids(n, direction, None)
                   for n in nodes}
        bc = {n: 0.0 for n in nodes}
        rng = random.Random(seed)
        sources = nodes
        if sampling_ratio < 1.0:
            ns = max(1, int(len(nodes) * sampling_ratio))
            sources = rng.sample(nodes, ns)
        for s in sources:
            # single-source shortest paths (BFS)
            stack: List[int] = []
            pred: Dict[int, List[int]] = {n: [] for n in nodes}
            sigma = {n: 0.0 for n in nodes}
            dist = {n: -1 for n in nodes}
            sigma[s] = 1.0
            dist[s] = 0
            queue = deque([s])
            while queue:
                v = queue.popleft()
                stack.append(v)
                for w in adj[v]:
                    if dist[w] < 0:
                        dist[w] = dist[v] + 1
                        queue.append(w)
                    if dist[w] == dist[v] + 1:
                        sigma[w] += sigma[v]
                        pred[w].append(v)
            delta = {n: 0.0 for n in nodes}
            while stack:
                w = stack.pop()
                for v in pred[w]:
                    if sigma[w] > 0:
                        delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
                if w != s:
                    bc[w] += delta[w]
        scale = 1.0
        if sampling_ratio < 1.0 and sources:
            scale = len(nodes) / len(sources)
        # undirected counts each pair twice
        if direction == "both":
            scale *= 0.5
        return {n: v * scale for n, v in bc.items()}

    def closeness_centrality(self, direction: str = "both"
                             ) -> Dict[int, float]:
        """1 / average shortest-path distance to reachable nodes."""
        with self._lock:
            nodes = sorted(self._nodes)
            adj = {n: self._neighbor_ids(n, direction, None)
                   for n in nodes}
        out = {}
        for s in nodes:
            dist = {s: 0}
            queue = deque([s])
            total = 0
            while queue:
                v = queue.popleft()
                for w in adj[v]:
                    if w not in dist:
                        dist[w] = dist[v] + 1
                        total += dist[w]
                        queue.append(w)
            reachable = len(dist) - 1
            if reachable > 0 and total > 0:
                # scaled closeness (handles disconnected graphs)
                out[s] = (reachable / (len(nodes) - 1)) * \
                    (reachable / total) if len(nodes) > 1 else 0.0
            else:
                out[s] = 0.0
        return out

    def eigenvector_centrality(self, max_iterations: int = 50,
                               tol: float = 1e-6) -> Dict[int, float]:
        """Power iteration over the edge list, on the engine's device;
        the convergence test reads one float back each iteration."""
        import torch

        src, dst, bsrc, bdst, valid, n = self._edge_arrays()
        x = np.asarray(valid.cpu(), np.float32)
        xj = torch.from_numpy(x / max(np.linalg.norm(x), 1e-30)).to(
            bsrc.device)

        def step(x):
            # iterate on (A + I): same eigenvectors as A, but the shift
            # prevents period-2 oscillation on bipartite graphs
            contrib = torch.zeros_like(x).index_add_(0, bdst, x[bsrc]) + x
            norm = torch.clamp(torch.linalg.vector_norm(contrib), min=1e-30)
            return contrib / norm

        for _ in range(max_iterations):
            nxt = step(xj)
            if float(torch.max(torch.abs(nxt - xj))) < tol:
                xj = nxt
                break
            xj = nxt
        vals = xj.cpu().numpy()
        with self._lock:
            return {nid: float(vals[nid]) for nid in self._nodes}

    def label_propagation(self, max_iterations: int = 20,
                          seed: int = 0) -> Dict[int, int]:
        """Community detection: each node adopts its neighbors' most
        frequent label until stable."""
        rng = random.Random(seed)
        with self._lock:
            nodes = sorted(self._nodes)
            adj = {n: self._neighbor_ids(n, "both", None) for n in nodes}
        labels = {n: n for n in nodes}
        for _ in range(max_iterations):
            order = list(nodes)
            rng.shuffle(order)
            changed = False
            for v in order:
                if not adj[v]:
                    continue
                counts: Dict[int, int] = {}
                for w in adj[v]:
                    counts[labels[w]] = counts.get(labels[w], 0) + 1
                best = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))
                if best[0] != labels[v] and \
                        counts.get(labels[v], 0) < best[1]:
                    labels[v] = best[0]
                    changed = True
            if not changed:
                break
        return labels

    def louvain(self, resolution: float = 1.0, max_passes: int = 5,
                seed: int = 0) -> Dict[int, int]:
        """Louvain community detection (first-phase local moves,
        repeated over aggregated graphs)."""
        rng = random.Random(seed)
        with self._lock:
            nodes = sorted(self._nodes)
            edges: List[tuple] = []
            for eid, e in self._edges.items():
                edges.append((e["src"], e["dst"], 1.0))
        community = {n: n for n in nodes}
        node_map = {n: n for n in nodes}  # original -> current super-node

        for _ in range(max_passes):
            # build weighted adjacency of the current graph
            adj: Dict[int, Dict[int, float]] = {}
            deg: Dict[int, float] = {}
            m2 = 0.0
            cur_nodes = sorted(set(node_map.values()))
            for n in cur_nodes:
                adj[n] = {}
                deg[n] = 0.0
            for s, d, w in edges:
                cs, cd = node_map[s], node_map[d]
                if cs == cd:
                    deg[cs] += 2 * w
                    m2 += 2 * w
                    continue
                adj[cs][cd] = adj[cs].get(cd, 0.0) + w
                adj[cd][cs] = adj[cd].get(cs, 0.0) + w
                deg[cs] += w
                deg[cd] += w
                m2 += 2 * w
            if m2 == 0:
                break
            comm = {n: n for n in cur_nodes}
            comm_deg = {n: deg[n] for n in cur_nodes}
            improved = True
            any_move = False
            while improved:
                improved = False
                order = list(cur_nodes)
                rng.shuffle(order)
                for v in order:
                    cv = comm[v]
                    comm_deg[cv] -= deg[v]
                    weights: Dict[int, float] = {}
                    for w, wt in adj[v].items():
                        weights[comm[w]] = weights.get(comm[w], 0.0) + wt
                    best_c, best_gain = cv, 0.0
                    for c, wt in weights.items():
                        gain = wt - resolution * comm_deg.get(c, 0.0) \
                            * deg[v] / m2
                        if gain > best_gain:
                            best_c, best_gain = c, gain
                    comm[v] = best_c
                    comm_deg[best_c] = comm_deg.get(best_c, 0.0) + deg[v]
                    if best_c != cv:
                        improved = True
                        any_move = True
            # aggregate
            node_map = {orig: comm[node_map[orig]] for orig in node_map}
            if not any_move:
                break
        # compact community ids
        ids = {c: i for i, c in enumerate(sorted(set(node_map.values())))}
        return {n: ids[node_map[n]] for n in nodes}
