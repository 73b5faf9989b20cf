"""Graph engine: property graph with device analytics (copy of
``neumann_tpu.engines.graph``).

Capability parity with graph_engine (graph_engine/src/lib.rs): labeled
nodes, typed directed/undirected edges with properties, neighbors,
BFS/DFS traversal with filters, shortest/weighted/all/variable-length
paths, pattern-ish lookups, property/fulltext/geo indexes, unique
constraints, batch ops, pagination, pagerank, connected components, and
the algorithms module (A*, SCC, k-core, MST, triangle counting, node
similarity, biconnected components).

Authoritative state lives in the TensorStore (``node:{id}`` /
``edge:{id}`` keys, like the reference's GraphTensor slab routing), so WAL
replay and snapshots rebuild the graph; the engine keeps host adjacency
caches and lazily materializes the edge list as int64 torch tensors on
the engine's ``device`` (default "cuda") for the analytics in
``neumann_tpu_torch.ops.graph_kernels`` (BFS levels, PageRank,
label-propagation components: scatter reductions instead of CPU
pointer-chasing). Only the device half differs from the original.
"""

from __future__ import annotations

import heapq
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.engines.graph_algorithms import GraphAlgorithmsMixin
from neumann_tpu_torch.store.tensor_store import (
    TensorData,
    TensorStore,
    TensorValue,
)
from neumann_tpu_torch.utils.errors import GraphError

NODE_PREFIX = "node:"
EDGE_PREFIX = "edge:"
_RESERVED = ("_label", "_src", "_dst", "_type", "_directed")

# TYPE constraint value types (bool checked before int: bool < int)
_TYPE_ALIASES = {
    "int": "int", "integer": "int", "bigint": "int", "smallint": "int",
    "float": "float", "double": "float", "real": "float",
    "numeric": "float", "decimal": "float",
    "string": "string", "text": "string", "varchar": "string",
    "char": "string", "bool": "bool", "boolean": "bool",
}
_TYPE_CHECKS = {
    "int": int, "float": (int, float), "string": str, "bool": bool,
}


@dataclass
class TraversalFilter:
    """Parity with TraversalFilter (graph_engine/src/lib.rs:594-650)."""

    node_label: Optional[str] = None
    edge_type: Optional[str] = None
    node_condition: Optional[Condition] = None
    max_depth: int = 0            # 0 = unbounded
    direction: str = "out"        # out | in | both


class GraphEngine(GraphAlgorithmsMixin):
    def __init__(self, store: Optional[TensorStore] = None, device="cuda"):
        self.store = store if store is not None else TensorStore()
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._nodes: Dict[int, dict] = {}     # id -> {label, props}
        self._edges: Dict[int, dict] = {}     # id -> {src,dst,type,directed,props}
        self._out: Dict[int, List[int]] = {}  # node -> [edge ids]
        self._in: Dict[int, List[int]] = {}
        self._next_node = 0
        self._next_edge = 0
        self._prop_indexes: Dict[str, Dict[object, Set[int]]] = {}
        self._fulltext: Dict[str, Dict[str, Set[int]]] = {}
        self._unique: Set[Tuple[str, str]] = set()   # (label, prop)
        self._constraints: Dict[str, dict] = {}      # name -> spec
        self._edge_version = 0
        self._edge_cache = None
        # keys whose mirror state was applied by a bulk op before the
        # store write: the put hook skips them (still fires for WAL
        # replay / snapshot load, where the mirror must rebuild)
        self._prewritten: Set[str] = set()
        self.store.on_put(self._on_store_put)
        self.store.on_delete(self._on_store_delete)

    # ------------------------------------------------------------------
    # store mirroring (rebuilds graph from WAL replay / snapshot load)
    # ------------------------------------------------------------------
    def _on_store_put(self, key: str, data: TensorData) -> None:
        if self._prewritten and key in self._prewritten:
            # set ops are GIL-atomic; only the bulk writer mutates it
            self._prewritten.discard(key)
            return
        if key.startswith(NODE_PREFIX):
            try:
                nid = int(key[len(NODE_PREFIX):])
            except ValueError:
                return
            label_v = data.get("_label")
            props = {n: v.value for n, v in data.fields.items()
                     if n not in _RESERVED and v.kind == "scalar"}
            with self._lock:
                old = self._nodes.get(nid)
                if old is not None:
                    self._unindex_node(nid, old["props"])
                self._nodes[nid] = {
                    "label": label_v.value if label_v else None,
                    "props": props}
                self._index_node(nid, props)
                self._out.setdefault(nid, [])
                self._in.setdefault(nid, [])
                self._next_node = max(self._next_node, nid + 1)
                self._bump_edges()
        elif key.startswith(EDGE_PREFIX):
            try:
                eid = int(key[len(EDGE_PREFIX):])
            except ValueError:
                return
            f = {n: v.value for n, v in data.fields.items()}
            with self._lock:
                if eid in self._edges:
                    self._detach_edge(eid)
                edge = {
                    "src": int(f["_src"]), "dst": int(f["_dst"]),
                    "type": f.get("_type"),
                    "directed": bool(f.get("_directed", True)),
                    "props": {n: v for n, v in f.items()
                              if n not in _RESERVED}}
                self._edges[eid] = edge
                self._out.setdefault(edge["src"], []).append(eid)
                self._in.setdefault(edge["dst"], []).append(eid)
                if not edge["directed"]:
                    self._out.setdefault(edge["dst"], []).append(eid)
                    self._in.setdefault(edge["src"], []).append(eid)
                self._next_edge = max(self._next_edge, eid + 1)
                self._bump_edges()

    def _on_store_delete(self, key: str) -> None:
        if key.startswith(NODE_PREFIX):
            try:
                nid = int(key[len(NODE_PREFIX):])
            except ValueError:
                return
            with self._lock:
                node = self._nodes.pop(nid, None)
                if node:
                    self._unindex_node(nid, node["props"])
                self._bump_edges()
        elif key.startswith(EDGE_PREFIX):
            try:
                eid = int(key[len(EDGE_PREFIX):])
            except ValueError:
                return
            with self._lock:
                if eid in self._edges:
                    self._detach_edge(eid)
                    del self._edges[eid]
                self._bump_edges()

    def _detach_edge(self, eid: int) -> None:
        e = self._edges[eid]
        for adj, node in ((self._out, e["src"]), (self._in, e["dst"])):
            lst = adj.get(node)
            if lst and eid in lst:
                lst.remove(eid)
        if not e["directed"]:
            for adj, node in ((self._out, e["dst"]), (self._in, e["src"])):
                lst = adj.get(node)
                if lst and eid in lst:
                    lst.remove(eid)

    def _bump_edges(self) -> None:
        self._edge_version += 1
        self._edge_cache = None
        self._adj_cache = {}

    def _adjacency(self, direction: str, edge_type: Optional[str]
                   ) -> Dict[int, List[int]]:
        """Version-cached full adjacency for one (direction, type) view
        — turns traversal's per-node edge-dict walks into dict lookups."""
        cache = getattr(self, "_adj_cache", None)
        if cache is None:
            cache = self._adj_cache = {}
        key = (direction, edge_type)
        adj = cache.get(key)
        if adj is None:
            adj = {nid: self._neighbor_ids(nid, direction, edge_type)
                   for nid in self._nodes}
            cache[key] = adj
        return adj

    # -- property indexing ---------------------------------------------------
    def _index_node(self, nid: int, props: dict) -> None:
        for prop, idx in self._prop_indexes.items():
            if prop in props:
                idx.setdefault(props[prop], set()).add(nid)
        for prop, inv in self._fulltext.items():
            v = props.get(prop)
            if isinstance(v, str):
                for tok in _tokenize(v):
                    inv.setdefault(tok, set()).add(nid)

    def _unindex_node(self, nid: int, props: dict) -> None:
        for prop, idx in self._prop_indexes.items():
            v = props.get(prop)
            if v in idx:
                idx[v].discard(nid)
        for prop, inv in self._fulltext.items():
            v = props.get(prop)
            if isinstance(v, str):
                for tok in _tokenize(v):
                    if tok in inv:
                        inv[tok].discard(nid)

    # ------------------------------------------------------------------
    # node CRUD
    # ------------------------------------------------------------------
    def create_node(self, label: str, properties: Optional[dict] = None
                    ) -> int:
        properties = dict(properties or {})
        for r in _RESERVED:
            if r in properties:
                raise GraphError(f"property name {r} is reserved")
        with self._lock:
            self._check_unique(label, properties, exclude=None)
            self._check_exists_constraints(label, properties)
            # reserve the id NOW: the put hook also bumps via max() (for
            # WAL-replay rebuilds), but waiting for it would let two
            # threads allocate the same id and overwrite each other
            nid = self._next_node
            self._next_node = nid + 1
        data = TensorData()
        data.set("_label", TensorValue.scalar(label))
        for k, v in properties.items():
            data.set(k, TensorValue.scalar(v))
        self.store.put(f"{NODE_PREFIX}{nid}", data)
        return nid

    def batch_create_nodes(self, items: Sequence[Tuple[str, Optional[dict]]]
                           ) -> List[int]:
        return [self.create_node(lbl, props) for lbl, props in items]

    def get_node(self, nid: int) -> Optional[dict]:
        with self._lock:
            node = self._nodes.get(nid)
            if node is None:
                return None
            return {"id": nid, "label": node["label"],
                    "properties": dict(node["props"])}

    def node_exists(self, nid: int) -> bool:
        with self._lock:
            return nid in self._nodes

    def update_node(self, nid: int, properties: dict) -> None:
        with self._lock:
            node = self._nodes.get(nid)
            if node is None:
                raise GraphError(f"no node {nid}")
            merged = {**node["props"], **properties}
            self._check_unique(node["label"], merged, exclude=nid)
            label = node["label"]
        data = TensorData()
        data.set("_label", TensorValue.scalar(label))
        for k, v in merged.items():
            if v is not None:
                data.set(k, TensorValue.scalar(v))
        self.store.put(f"{NODE_PREFIX}{nid}", data)

    def delete_node(self, nid: int) -> bool:
        with self._lock:
            if nid not in self._nodes:
                return False
            doomed = set(self._out.get(nid, [])) | set(self._in.get(nid, []))
        for eid in doomed:
            self.store.delete(f"{EDGE_PREFIX}{eid}")
        return self.store.delete(f"{NODE_PREFIX}{nid}")

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def find_nodes(self, label: Optional[str] = None,
                   condition: Optional[Condition] = None,
                   limit: Optional[int] = None, offset: int = 0
                   ) -> List[dict]:
        with self._lock:
            out = []
            for nid in sorted(self._nodes):
                node = self._nodes[nid]
                if label is not None and node["label"] != label:
                    continue
                if condition is not None and \
                        not condition.evaluate_row(node["props"]):
                    continue
                out.append({"id": nid, "label": node["label"],
                            "properties": dict(node["props"])})
        if offset:
            out = out[offset:]
        return out[:limit] if limit is not None else out

    def find_nodes_by_property(self, prop: str, value) -> List[int]:
        with self._lock:
            idx = self._prop_indexes.get(prop)
            if idx is not None:
                return sorted(idx.get(value, set()) & set(self._nodes))
            return [nid for nid, n in sorted(self._nodes.items())
                    if n["props"].get(prop) == value]

    # ------------------------------------------------------------------
    # edge CRUD
    # ------------------------------------------------------------------
    def create_edge(self, src: int, dst: int, edge_type: str,
                    properties: Optional[dict] = None,
                    directed: bool = True) -> int:
        with self._lock:
            if src not in self._nodes:
                raise GraphError(f"no node {src}")
            if dst not in self._nodes:
                raise GraphError(f"no node {dst}")
            # reserved here, not in the hook, for the same reason as
            # create_node: concurrent allocators must never collide
            eid = self._next_edge
            self._next_edge = eid + 1
        data = TensorData()
        data.set("_src", TensorValue.scalar(src))
        data.set("_dst", TensorValue.scalar(dst))
        data.set("_type", TensorValue.scalar(edge_type))
        data.set("_directed", TensorValue.scalar(directed))
        for k, v in (properties or {}).items():
            data.set(k, TensorValue.scalar(v))
        self.store.put(f"{EDGE_PREFIX}{eid}", data)
        return eid

    def batch_create_edges(self, items) -> List[int]:
        """Bulk edge insert: one engine lock for allocation + mirror
        update, then the store writes (durability) with the mirror
        hook short-circuited — ~6x the per-edge path."""
        norm = []
        for item in items:
            src, dst, etype = item[0], item[1], item[2]
            props = item[3] if len(item) > 3 else None
            directed = item[4] if len(item) > 4 else True
            norm.append((int(src), int(dst), etype, props or {},
                         bool(directed)))
        with self._lock:
            for src, dst, _, _, _ in norm:
                if src not in self._nodes:
                    raise GraphError(f"no node {src}")
                if dst not in self._nodes:
                    raise GraphError(f"no node {dst}")
            eids = list(range(self._next_edge,
                              self._next_edge + len(norm)))
            self._next_edge += len(norm)
            out, inn = self._out, self._in
            for eid, (src, dst, etype, props, directed) in zip(eids,
                                                               norm):
                self._edges[eid] = {
                    "src": src, "dst": dst, "type": etype,
                    "directed": directed, "props": dict(props)}
                out.setdefault(src, []).append(eid)
                inn.setdefault(dst, []).append(eid)
                if not directed:
                    out.setdefault(dst, []).append(eid)
                    inn.setdefault(src, []).append(eid)
                self._prewritten.add(f"{EDGE_PREFIX}{eid}")
            self._bump_edges()
        scalar = TensorValue.scalar
        tv_cache: dict = {}      # TensorValue is frozen: share repeats
        for eid, (src, dst, etype, props, directed) in zip(eids, norm):
            data = TensorData()
            fields = data.fields
            fields["_src"] = scalar(src)
            fields["_dst"] = scalar(dst)
            tv = tv_cache.get(etype)
            if tv is None:
                tv = tv_cache[etype] = scalar(etype)
            fields["_type"] = tv
            tv = tv_cache.get(directed)
            if tv is None:
                tv = tv_cache[directed] = scalar(directed)
            fields["_directed"] = tv
            for k, v in props.items():
                fields[k] = scalar(v)
            self.store.put(f"{EDGE_PREFIX}{eid}", data)
        return eids

    def get_edge(self, eid: int) -> Optional[dict]:
        with self._lock:
            e = self._edges.get(eid)
            if e is None:
                return None
            return {"id": eid, "src": e["src"], "dst": e["dst"],
                    "type": e["type"], "directed": e["directed"],
                    "properties": {k: v.value for k, v in e["props"].items()
                                   if hasattr(v, "value")} or
                    dict(e["props"])}

    def delete_edge(self, eid: int) -> bool:
        return self.store.delete(f"{EDGE_PREFIX}{eid}")

    def edge_count(self) -> int:
        with self._lock:
            return len(self._edges)

    def edges_between(self, src: int, dst: int,
                      edge_type: Optional[str] = None) -> List[int]:
        with self._lock:
            out = []
            for eid in self._out.get(src, []):
                e = self._edges[eid]
                other = e["dst"] if e["src"] == src else e["src"]
                if other == dst and (edge_type is None
                                     or e["type"] == edge_type):
                    out.append(eid)
            return out

    def out_edges(self, nid: int) -> List[dict]:
        """Edges leaving ``nid`` (undirected edges incident at it count
        too), as get_edge dicts."""
        with self._lock:
            return [self.get_edge(eid)
                    for eid in list(self._out.get(nid, []))]

    def in_edges(self, nid: int) -> List[dict]:
        with self._lock:
            return [self.get_edge(eid)
                    for eid in list(self._in.get(nid, []))]

    # ------------------------------------------------------------------
    # neighborhood / traversal
    # ------------------------------------------------------------------
    def _neighbor_ids(self, nid: int, direction: str,
                      edge_type: Optional[str]) -> List[int]:
        out: List[int] = []
        if direction in ("out", "both"):
            for eid in self._out.get(nid, []):
                e = self._edges[eid]
                if edge_type is not None and e["type"] != edge_type:
                    continue
                out.append(e["dst"] if e["src"] == nid else e["src"])
        if direction in ("in", "both"):
            for eid in self._in.get(nid, []):
                e = self._edges[eid]
                if edge_type is not None and e["type"] != edge_type:
                    continue
                if e["directed"]:
                    out.append(e["src"])
                else:
                    other = e["src"] if e["dst"] == nid else e["dst"]
                    out.append(other)
        # Self-loops are not neighbors (lib.rs:4043-4047 parity).
        seen = set()
        uniq = []
        for x in out:
            if x not in seen and x != nid:
                seen.add(x)
                uniq.append(x)
        return uniq

    def neighbors(self, nid: int, direction: str = "out",
                  edge_type: Optional[str] = None) -> List[int]:
        with self._lock:
            if nid not in self._nodes:
                raise GraphError(f"no node {nid}")
            return sorted(self._neighbor_ids(nid, direction, edge_type))

    def get_entity_neighbors(self, nid: int) -> Set[int]:
        """Undirected neighbor set (unified hybrid queries)."""
        with self._lock:
            if nid not in self._nodes:
                return set()
            return set(self._neighbor_ids(nid, "both", None))

    def traverse(self, start: int, filter: Optional[TraversalFilter] = None,
                 order: str = "bfs") -> List[Tuple[int, int]]:
        """Returns [(node_id, depth)] in visit order."""
        from collections import deque

        f = filter or TraversalFilter()
        with self._lock:
            if start not in self._nodes:
                raise GraphError(f"no node {start}")
            visited = {start}
            result = [(start, 0)]
            frontier = deque([(start, 0)])
            adj = self._adjacency(f.direction, f.edge_type)
            while frontier:
                if order == "bfs":
                    nid, depth = frontier.popleft()
                else:
                    nid, depth = frontier.pop()
                if f.max_depth and depth >= f.max_depth:
                    continue
                for nb in adj.get(nid, ()):
                    if nb in visited:
                        continue
                    node = self._nodes.get(nb)
                    if node is None:
                        continue
                    if f.node_label is not None and \
                            node["label"] != f.node_label:
                        continue
                    if f.node_condition is not None and \
                            not f.node_condition.evaluate_row(node["props"]):
                        continue
                    visited.add(nb)
                    result.append((nb, depth + 1))
                    frontier.append((nb, depth + 1))
            return result

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------
    def find_path(self, a: int, b: int, max_depth: int = 0
                  ) -> Optional[List[int]]:
        """Shortest unweighted path (BFS with parent tracking)."""
        with self._lock:
            if a not in self._nodes or b not in self._nodes:
                raise GraphError("path endpoints must exist")
            if a == b:
                return [a]
            parent = {a: None}
            frontier = [a]
            depth = 0
            while frontier:
                depth += 1
                if max_depth and depth > max_depth:
                    return None
                nxt = []
                for nid in frontier:
                    for nb in self._neighbor_ids(nid, "out", None):
                        if nb in parent:
                            continue
                        parent[nb] = nid
                        if nb == b:
                            path = [b]
                            while path[-1] != a:
                                path.append(parent[path[-1]])
                            return list(reversed(path))
                        nxt.append(nb)
                frontier = nxt
            return None

    def find_weighted_path(self, a: int, b: int, weight_prop: str = "weight"
                           ) -> Optional[Tuple[List[int], float]]:
        """Dijkstra by edge property (default weight 1.0)."""
        with self._lock:
            if a not in self._nodes or b not in self._nodes:
                raise GraphError("path endpoints must exist")
            dist = {a: 0.0}
            parent: Dict[int, Optional[int]] = {a: None}
            heap = [(0.0, a)]
            done = set()
            while heap:
                d, nid = heapq.heappop(heap)
                if nid in done:
                    continue
                done.add(nid)
                if nid == b:
                    path = [b]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    return list(reversed(path)), d
                for eid in self._out.get(nid, []):
                    e = self._edges[eid]
                    nb = e["dst"] if e["src"] == nid else e["src"]
                    w = e["props"].get(weight_prop)
                    w = float(w.value if hasattr(w, "value") else w) \
                        if w is not None else 1.0
                    if w < 0:
                        raise GraphError("negative edge weight")
                    nd = d + w
                    if nd < dist.get(nb, math.inf):
                        dist[nb] = nd
                        parent[nb] = nid
                        heapq.heappush(heap, (nd, nb))
            return None

    def find_all_paths(self, a: int, b: int, max_depth: int = 10
                       ) -> List[List[int]]:
        """All simple paths up to max_depth edges (DFS)."""
        with self._lock:
            if a not in self._nodes or b not in self._nodes:
                raise GraphError("path endpoints must exist")
            out: List[List[int]] = []
            stack = [(a, [a])]
            while stack:
                nid, path = stack.pop()
                if len(path) - 1 > max_depth:
                    continue
                if nid == b and len(path) > 1 or (nid == b and a == b):
                    out.append(path)
                    continue
                if nid == b:
                    out.append(path)
                    continue
                if len(path) - 1 == max_depth:
                    continue
                for nb in self._neighbor_ids(nid, "out", None):
                    if nb not in path:
                        stack.append((nb, path + [nb]))
            return sorted(out, key=len)

    def find_variable_paths(self, a: int, b: int, min_depth: int,
                            max_depth: int) -> List[List[int]]:
        return [p for p in self.find_all_paths(a, b, max_depth)
                if min_depth <= len(p) - 1 <= max_depth]

    # ------------------------------------------------------------------
    # device analytics
    # ------------------------------------------------------------------
    def _edge_arrays(self):
        """(src, dst, both_src, both_dst, valid, n): int64 edge tensors
        and the bool [n] node mask on the engine's device, cached until
        the next node or edge change."""
        with self._lock:
            if self._edge_cache is not None:
                return self._edge_cache
            n = max(self._next_node, 1)
            src, dst = [], []
            for e in self._edges.values():
                src.append(e["src"])
                dst.append(e["dst"])
                if not e["directed"]:
                    src.append(e["dst"])
                    dst.append(e["src"])
            if not src:
                src, dst = [0], [0]  # dummy self-loop on padding slot
            valid = np.zeros(n, bool)
            valid[list(self._nodes)] = True
            src = np.asarray(src, np.int64)
            dst = np.asarray(dst, np.int64)

            def dev(a):
                return torch.from_numpy(a).to(self.device)

            cache = (dev(src), dev(dst), dev(np.concatenate([src, dst])),
                     dev(np.concatenate([dst, src])), dev(valid), n)
            self._edge_cache = cache
            return cache

    def pagerank(self, damping: float = 0.85, iters: int = 20
                 ) -> Dict[int, float]:
        from neumann_tpu_torch.ops.graph_kernels import pagerank as pr

        src, dst, _, _, valid, n = self._edge_arrays()
        ranks = pr(src, dst, n, valid, damping, iters).cpu().numpy()
        with self._lock:
            return {nid: float(ranks[nid]) for nid in self._nodes}

    def connected_components(self) -> Dict[int, int]:
        from neumann_tpu_torch.ops.graph_kernels import (
            connected_components as cc,
        )

        _, _, bsrc, bdst, valid, n = self._edge_arrays()
        labels = cc(bsrc, bdst, n, valid).cpu().numpy()
        with self._lock:
            return {nid: int(labels[nid]) for nid in self._nodes}

    def bfs_levels(self, start: int, max_depth: int = 0,
                   direction: str = "out") -> Dict[int, int]:
        """Device BFS: hop distance from start for every reachable node."""
        from neumann_tpu_torch.ops.graph_kernels import bfs_levels as bl

        src, dst, bsrc, bdst, valid, n = self._edge_arrays()
        if direction == "both":
            src, dst = bsrc, bdst
        start_mask = torch.zeros(n, dtype=torch.bool, device=src.device)
        start_mask[start] = True
        levels = bl(src, dst, n, start_mask, max_depth).cpu().numpy()
        with self._lock:
            return {nid: int(levels[nid]) for nid in self._nodes
                    if levels[nid] >= 0}

    # ------------------------------------------------------------------
    # algorithms (graph_engine/src/algorithms/*.rs parity)
    # ------------------------------------------------------------------
    def astar(self, a: int, b: int, weight_prop: str = "weight",
              pos_props: Tuple[str, str] = ("x", "y")
              ) -> Optional[Tuple[List[int], float]]:
        with self._lock:
            if a not in self._nodes or b not in self._nodes:
                raise GraphError("path endpoints must exist")

            def pos(nid):
                p = self._nodes[nid]["props"]
                x, y = p.get(pos_props[0]), p.get(pos_props[1])
                return (float(x), float(y)) if x is not None and \
                    y is not None else None

            goal = pos(b)

            def h(nid):
                if goal is None:
                    return 0.0
                p = pos(nid)
                if p is None:
                    return 0.0
                return math.hypot(p[0] - goal[0], p[1] - goal[1])

            g = {a: 0.0}
            parent: Dict[int, Optional[int]] = {a: None}
            heap = [(h(a), a)]
            done = set()
            while heap:
                _, nid = heapq.heappop(heap)
                if nid in done:
                    continue
                done.add(nid)
                if nid == b:
                    path = [b]
                    while parent[path[-1]] is not None:
                        path.append(parent[path[-1]])
                    return list(reversed(path)), g[b]
                for eid in self._out.get(nid, []):
                    e = self._edges[eid]
                    nb = e["dst"] if e["src"] == nid else e["src"]
                    w = e["props"].get(weight_prop)
                    w = float(w.value if hasattr(w, "value") else w) \
                        if w is not None else 1.0
                    ng = g[nid] + w
                    if ng < g.get(nb, math.inf):
                        g[nb] = ng
                        parent[nb] = nid
                        heapq.heappush(heap, (ng + h(nb), nb))
            return None

    def triangle_count(self) -> int:
        with self._lock:
            adj = {nid: set(self._neighbor_ids(nid, "both", None))
                   for nid in self._nodes}
        count = 0
        for a, nbrs in adj.items():
            for b in nbrs:
                if b <= a:
                    continue
                count += sum(1 for c in (adj[a] & adj.get(b, set()))
                             if c > b)
        return count

    def k_core(self, k: int) -> Set[int]:
        with self._lock:
            adj = {nid: set(self._neighbor_ids(nid, "both", None))
                   for nid in self._nodes}
        alive = set(adj)
        changed = True
        while changed:
            changed = False
            for nid in list(alive):
                if len(adj[nid] & alive) < k:
                    alive.discard(nid)
                    changed = True
        return alive

    def minimum_spanning_tree(self, weight_prop: str = "weight"
                              ) -> List[int]:
        """Kruskal; returns edge ids of the forest."""
        with self._lock:
            edges = []
            for eid, e in self._edges.items():
                w = e["props"].get(weight_prop)
                w = float(w.value if hasattr(w, "value") else w) \
                    if w is not None else 1.0
                edges.append((w, eid, e["src"], e["dst"]))
            nodes = list(self._nodes)
        parent = {n: n for n in nodes}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        out = []
        for w, eid, s, d in sorted(edges):
            rs, rd = find(s), find(d)
            if rs != rd:
                parent[rs] = rd
                out.append(eid)
        return out

    def strongly_connected_components(self) -> Dict[int, int]:
        """Tarjan (iterative)."""
        with self._lock:
            succ = {nid: [self._edges[eid]["dst"]
                          for eid in self._out.get(nid, [])
                          if self._edges[eid]["directed"]
                          and self._edges[eid]["src"] == nid]
                    for nid in self._nodes}
            # undirected edges connect both ways for SCC purposes
            for nid in self._nodes:
                for eid in self._out.get(nid, []):
                    e = self._edges[eid]
                    if not e["directed"]:
                        other = e["dst"] if e["src"] == nid else e["src"]
                        succ[nid].append(other)
        index: Dict[int, int] = {}
        low: Dict[int, int] = {}
        comp: Dict[int, int] = {}
        counter = [0]
        ncomp = [0]
        stack: List[int] = []
        on_stack: Set[int] = set()
        for root in succ:
            if root in index:
                continue
            work = [(root, 0)]
            while work:
                nid, pi = work[-1]
                if pi == 0:
                    index[nid] = low[nid] = counter[0]
                    counter[0] += 1
                    stack.append(nid)
                    on_stack.add(nid)
                advanced = False
                children = succ[nid]
                while pi < len(children):
                    ch = children[pi]
                    pi += 1
                    work[-1] = (nid, pi)
                    if ch not in index:
                        work.append((ch, 0))
                        advanced = True
                        break
                    if ch in on_stack:
                        low[nid] = min(low[nid], index[ch])
                if advanced:
                    continue
                if low[nid] == index[nid]:
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp[w] = ncomp[0]
                        if w == nid:
                            break
                    ncomp[0] += 1
                work.pop()
                if work:
                    pnid, _ = work[-1]
                    low[pnid] = min(low[pnid], low[nid])
        return comp

    def biconnected_components(self) -> List[Set[int]]:
        """Edge-partition biconnected components (iterative Hopcroft-Tarjan);
        returns sets of node ids."""
        with self._lock:
            adj = {nid: list(self._neighbor_ids(nid, "both", None))
                   for nid in self._nodes}
        index: Dict[int, int] = {}
        low: Dict[int, int] = {}
        counter = [0]
        comps: List[Set[int]] = []
        estack: List[Tuple[int, int]] = []
        for root in adj:
            if root in index:
                continue
            work: List[Tuple[int, Optional[int], int]] = [(root, None, 0)]
            while work:
                nid, par, pi = work[-1]
                if pi == 0:
                    index[nid] = low[nid] = counter[0]
                    counter[0] += 1
                advanced = False
                children = adj[nid]
                while pi < len(children):
                    ch = children[pi]
                    pi += 1
                    work[-1] = (nid, par, pi)
                    if ch not in index:
                        estack.append((nid, ch))
                        work.append((ch, nid, 0))
                        advanced = True
                        break
                    if ch != par and index[ch] < index[nid]:
                        estack.append((nid, ch))
                        low[nid] = min(low[nid], index[ch])
                if advanced:
                    continue
                work.pop()
                if work:
                    pnid = work[-1][0]
                    low[pnid] = min(low[pnid], low[nid])
                    if low[nid] >= index[pnid]:
                        comp: Set[int] = set()
                        while estack:
                            u, v = estack.pop()
                            comp.add(u)
                            comp.add(v)
                            if (u, v) == (pnid, nid):
                                break
                        if comp:
                            comps.append(comp)
        return comps

    def node_similarity(self, a: int, b: int) -> float:
        """Jaccard similarity of neighbor sets."""
        with self._lock:
            na = set(self._neighbor_ids(a, "both", None)) \
                if a in self._nodes else set()
            nb = set(self._neighbor_ids(b, "both", None)) \
                if b in self._nodes else set()
        if not na and not nb:
            return 0.0
        return len(na & nb) / len(na | nb)

    # ------------------------------------------------------------------
    # indexes / constraints / fulltext / geo
    # ------------------------------------------------------------------
    def create_property_index(self, prop: str) -> None:
        with self._lock:
            if prop in self._prop_indexes:
                return
            idx: Dict[object, Set[int]] = {}
            for nid, node in self._nodes.items():
                if prop in node["props"]:
                    idx.setdefault(node["props"][prop], set()).add(nid)
            self._prop_indexes[prop] = idx

    def drop_property_index(self, prop: str) -> bool:
        with self._lock:
            return self._prop_indexes.pop(prop, None) is not None

    def create_fulltext_index(self, prop: str) -> None:
        with self._lock:
            if prop in self._fulltext:
                return
            inv: Dict[str, Set[int]] = {}
            for nid, node in self._nodes.items():
                v = node["props"].get(prop)
                if isinstance(v, str):
                    for tok in _tokenize(v):
                        inv.setdefault(tok, set()).add(nid)
            self._fulltext[prop] = inv

    def search_fulltext(self, prop: str, query: str) -> List[int]:
        with self._lock:
            inv = self._fulltext.get(prop)
            if inv is None:
                raise GraphError(f"no fulltext index on {prop}")
            toks = _tokenize(query)
            if not toks:
                return []
            sets = [inv.get(t, set()) for t in toks]
            hit = set.intersection(*sets) if sets else set()
            return sorted(hit & set(self._nodes))

    def create_constraint(self, name: str, target: str, prop: str,
                          kind: str, label: Optional[str] = None,
                          vtype: Optional[str] = None) -> None:
        """Named constraint: kind in unique|exists|type, target node|edge.

        ``type`` constraints (reference ConstraintType::Type,
        neumann_parser/src/parser.rs:2752-2756) require the property,
        when present, to hold a value of ``vtype`` (int/float/string/
        bool); enforced at node create like exists constraints.
        """
        if name in self._constraints:
            raise GraphError(f"constraint '{name}' exists")
        if kind == "unique":
            if target != "node":
                raise GraphError("unique constraints apply to nodes")
            self.create_unique_constraint(label or "", prop)
        elif kind == "type":
            if vtype is None:
                raise GraphError("type constraint needs a value type")
            vtype = _TYPE_ALIASES.get(vtype.lower())
            if vtype is None:
                raise GraphError(
                    "type constraint type must be one of "
                    "int/float/string/bool")
        elif kind != "exists":
            raise GraphError(f"unknown constraint kind {kind}")
        self._constraints[name] = {"name": name, "target": target,
                                   "prop": prop, "kind": kind,
                                   "label": label, "vtype": vtype}

    def drop_constraint(self, name: str) -> bool:
        spec = self._constraints.pop(name, None)
        if spec is None:
            return False
        if spec["kind"] == "unique":
            self._unique.discard((spec["label"] or "", spec["prop"]))
        return True

    def list_constraints(self) -> List[dict]:
        return [dict(v) for v in self._constraints.values()]

    def get_constraint(self, name: str) -> Optional[dict]:
        spec = self._constraints.get(name)
        return dict(spec) if spec else None

    def _check_exists_constraints(self, label: str, props: dict) -> None:
        for spec in self._constraints.values():
            if spec["target"] != "node":
                continue
            if spec["label"] not in (None, label):
                continue
            if spec["kind"] == "exists":
                if props.get(spec["prop"]) is None:
                    raise GraphError(
                        f"constraint {spec['name']}: property "
                        f"'{spec['prop']}' required")
            elif spec["kind"] == "type":
                v = props.get(spec["prop"])
                if v is None:
                    continue
                want = spec["vtype"]
                ok = isinstance(v, _TYPE_CHECKS[want]) and not (
                    want in ("int", "float") and isinstance(v, bool))
                if not ok:
                    raise GraphError(
                        f"constraint {spec['name']}: property "
                        f"'{spec['prop']}' must be {want}")

    def create_unique_constraint(self, label: str, prop: str) -> None:
        with self._lock:
            seen = set()
            for node in self._nodes.values():
                if node["label"] != label:
                    continue
                v = node["props"].get(prop)
                if v is None:
                    continue
                if v in seen:
                    raise GraphError(
                        f"existing duplicate for {label}.{prop}")
                seen.add(v)
            self._unique.add((label, prop))

    def _check_unique(self, label: str, props: dict,
                      exclude: Optional[int]) -> None:
        for ulabel, uprop in self._unique:
            if ulabel != label or uprop not in props:
                continue
            v = props[uprop]
            for nid, node in self._nodes.items():
                if nid == exclude:
                    continue
                if node["label"] == label and \
                        node["props"].get(uprop) == v:
                    raise GraphError(
                        f"unique constraint {label}.{uprop} violated")

    def geo_search(self, lat: float, lon: float, radius_km: float,
                   lat_prop: str = "lat", lon_prop: str = "lon"
                   ) -> List[Tuple[int, float]]:
        """Haversine radius search over node coordinates."""
        with self._lock:
            nodes = [(nid, n["props"].get(lat_prop), n["props"].get(lon_prop))
                     for nid, n in self._nodes.items()]
        out = []
        for nid, nlat, nlon in nodes:
            if nlat is None or nlon is None:
                continue
            d = _haversine_km(lat, lon, float(nlat), float(nlon))
            if d <= radius_km:
                out.append((nid, d))
        out.sort(key=lambda t: t[1])
        return out


def _tokenize(s: str) -> List[str]:
    out = []
    cur = []
    for ch in s.lower():
        if ch.isalnum():
            cur.append(ch)
        elif cur:
            out.append("".join(cur))
            cur = []
    if cur:
        out.append("".join(cur))
    return out


def _haversine_km(lat1, lon1, lat2, lon2) -> float:
    r = 6371.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * \
        math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))
