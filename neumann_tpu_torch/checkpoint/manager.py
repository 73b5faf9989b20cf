"""Checkpoint / rollback manager.

Capability parity with tensor_checkpoint (tensor_checkpoint/src/): named
checkpoints, automatic checkpoints before destructive operations
(DELETE/DROP/..., the DestructiveOp enum), rollback by id or name,
count-based retention, previews. Snapshots are full TensorStore snapshots
written to a checkpoint directory (the reference stores them via
tensor_blob; file-per-checkpoint is equivalent here).

The port's copy of ``neumann_tpu/checkpoint/manager.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from neumann_tpu_torch.store.tensor_store import TensorStore
from neumann_tpu_torch.utils.errors import CheckpointError

DESTRUCTIVE_OPS = ("delete", "drop_table", "drop_index", "drop_collection",
                   "update", "rollback")


class CheckpointManager:
    def __init__(self, store: TensorStore, directory: str,
                 retention: int = 20):
        self.store = store
        self.dir = os.fspath(directory)
        self.retention = retention
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.RLock()
        self._index_path = os.path.join(self.dir, "index.json")
        self._index: List[dict] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as fh:
                self._index = json.load(fh)
        self._counter = max(
            (c["seq"] for c in self._index), default=0)

    def _save_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._index, fh)
        os.replace(tmp, self._index_path)

    # ------------------------------------------------------------------
    def create(self, name: Optional[str] = None, auto: bool = False,
               reason: Optional[str] = None) -> str:
        with self._lock:
            self._counter += 1
            seq = self._counter
            cid = f"ckpt-{seq}"
            path = os.path.join(self.dir, f"{cid}.ntpu")
            self.store.save_snapshot(path)
            self._index.append({
                "id": cid, "seq": seq, "name": name, "auto": auto,
                "reason": reason, "created": time.time(),
                "entries": len(self.store), "path": path})
            # retention: drop oldest auto checkpoints beyond the limit
            autos = [c for c in self._index if c["auto"]]
            while len(autos) > self.retention:
                victim = autos.pop(0)
                self._index.remove(victim)
                if os.path.exists(victim["path"]):
                    os.remove(victim["path"])
            self._save_index()
            return cid

    def auto_checkpoint(self, op: str, detail: str = "") -> Optional[str]:
        """Checkpoint before a destructive op (no-op for other ops)."""
        if op not in DESTRUCTIVE_OPS:
            return None
        return self.create(auto=True, reason=f"{op} {detail}".strip())

    def list(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(reversed(self._index))
        return out[:limit] if limit else out

    def _find(self, target: str) -> dict:
        with self._lock:
            for c in reversed(self._index):
                if c["id"] == target or c["name"] == target:
                    return c
        raise CheckpointError(f"no checkpoint '{target}'")

    def preview(self, target: str) -> dict:
        c = self._find(target)
        return {"id": c["id"], "name": c["name"], "created": c["created"],
                "entries": c["entries"], "reason": c["reason"],
                "current_entries": len(self.store)}

    def rollback(self, target: str) -> dict:
        """Restore store state; an auto checkpoint of the pre-rollback
        state is taken first so rollback itself is reversible."""
        c = self._find(target)
        if not os.path.exists(c["path"]):
            raise CheckpointError(f"snapshot file missing for {c['id']}")
        self.create(auto=True, reason=f"rollback to {c['id']}")
        self.store.clear()
        self.store.load_snapshot(c["path"])
        return c

    def delete(self, target: str) -> bool:
        try:
            c = self._find(target)
        except CheckpointError:
            return False
        with self._lock:
            self._index.remove(c)
            self._save_index()
        if os.path.exists(c["path"]):
            os.remove(c["path"])
        return True
