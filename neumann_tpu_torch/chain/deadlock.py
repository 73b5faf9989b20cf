"""Wait-for-graph deadlock detection (tensor_chain/src/deadlock.rs parity).

The port's copy of ``neumann_tpu/chain/deadlock.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set


class DeadlockDetector:
    def __init__(self):
        self._edges: Dict[str, Set[str]] = {}
        self._lock = threading.Lock()

    def add_wait(self, waiter: str, holder: str) -> None:
        with self._lock:
            self._edges.setdefault(waiter, set()).add(holder)

    def remove_waiter(self, waiter: str) -> None:
        with self._lock:
            self._edges.pop(waiter, None)

    def clear(self) -> None:
        with self._lock:
            self._edges.clear()

    def find_cycle(self) -> Optional[List[str]]:
        """DFS cycle detection; returns a cycle as a list of tx ids."""
        with self._lock:
            edges = {k: set(v) for k, v in self._edges.items()}
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in edges}
        parent: Dict[str, Optional[str]] = {}
        for root in edges:
            if color.get(root, WHITE) != WHITE:
                continue
            stack = [(root, iter(edges.get(root, ())))]
            color[root] = GRAY
            parent[root] = None
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    if color.get(nxt, WHITE) == GRAY:
                        # found cycle: walk back from node to nxt
                        cycle = [nxt, node]
                        cur = parent.get(node)
                        while cur is not None and cur != nxt:
                            cycle.append(cur)
                            cur = parent.get(cur)
                        cycle.reverse()
                        return cycle
                    if color.get(nxt, WHITE) == WHITE and nxt in edges:
                        color[nxt] = GRAY
                        parent[nxt] = node
                        stack.append((nxt, iter(edges.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return None

    def victim(self) -> Optional[str]:
        """Pick a tx to abort: the youngest (max id) in the cycle."""
        cycle = self.find_cycle()
        if not cycle:
            return None
        return max(cycle)
