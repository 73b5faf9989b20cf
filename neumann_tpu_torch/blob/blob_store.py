"""S3-style chunked blob storage.

Capability parity with tensor_blob (tensor_blob/src/): SHA-256
content-addressed chunks with dedup refcounts, streaming writer/reader,
artifact metadata (content type, creator, tags, custom meta), entity
links, garbage collection, integrity verify/repair, stats. Chunks and
artifact records live in the shared TensorStore (``_chunk:`` /
``_blob:`` keys), so store durability covers blobs too.

The port's copy of ``neumann_tpu/blob/blob_store.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
import threading
import time
from fnmatch import fnmatch
from typing import Dict, Iterator, List, Optional

from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore, TensorValue
from neumann_tpu_torch.utils.errors import BlobError

CHUNK_SIZE = 1 << 20  # 1 MiB
_BLOB = "_blob:"
_CHUNK = "_chunk:"


class BlobWriter:
    """Streaming writer: feed bytes, finish() returns the artifact id."""

    def __init__(self, store: "BlobStore", name: str,
                 content_type: Optional[str], creator: Optional[str]):
        self._store = store
        self._name = name
        self._content_type = content_type
        self._creator = creator
        self._buf = bytearray()
        self._chunks: List[str] = []
        self._size = 0
        self._sha = hashlib.sha256()
        self._done = False

    def write(self, data: bytes) -> None:
        if self._done:
            raise BlobError("writer already finished")
        self._buf += data
        self._size += len(data)
        self._sha.update(data)
        while len(self._buf) >= CHUNK_SIZE:
            chunk = bytes(self._buf[:CHUNK_SIZE])
            del self._buf[:CHUNK_SIZE]
            self._chunks.append(self._store._put_chunk(chunk))

    def finish(self) -> str:
        if self._done:
            raise BlobError("writer already finished")
        self._done = True
        if self._buf:
            self._chunks.append(self._store._put_chunk(bytes(self._buf)))
            self._buf.clear()
        return self._store._register(
            self._name, self._chunks, self._size,
            self._sha.hexdigest(), self._content_type, self._creator)


class BlobStore:
    def __init__(self, store: Optional[TensorStore] = None):
        self.store = store if store is not None else TensorStore()
        self._lock = threading.RLock()
        self._next = 0
        # recover id counter from existing artifacts
        for k in self.store.scan(_BLOB):
            try:
                n = int(k[len(_BLOB):].split("-")[1])
                self._next = max(self._next, n + 1)
            except (IndexError, ValueError):
                pass

    # -- chunks -----------------------------------------------------------
    def _put_chunk(self, data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        key = _CHUNK + digest
        with self._lock:
            existing = self.store.get(key)
            if existing is not None:
                refs = existing.get("refs").value + 1
                td = TensorData()
                td.set("data", TensorValue.scalar(existing.get("data").value))
                td.set("refs", TensorValue.scalar(refs))
                self.store.put(key, td)
            else:
                td = TensorData()
                td.set("data", TensorValue.scalar(data))
                td.set("refs", TensorValue.scalar(1))
                self.store.put(key, td)
        return digest

    def _unref_chunk(self, digest: str) -> None:
        key = _CHUNK + digest
        with self._lock:
            existing = self.store.get(key)
            if existing is None:
                return
            refs = existing.get("refs").value - 1
            td = TensorData()
            td.set("data", TensorValue.scalar(existing.get("data").value))
            td.set("refs", TensorValue.scalar(refs))
            self.store.put(key, td)  # GC sweeps refs<=0

    # -- artifacts ---------------------------------------------------------
    def _register(self, name, chunks, size, checksum, content_type,
                  creator) -> str:
        with self._lock:
            artifact_id = f"art-{self._next}"
            self._next += 1
        td = TensorData()
        td.set("name", TensorValue.scalar(name))
        td.set("chunks", TensorValue.pointers([_CHUNK + c for c in chunks]))
        td.set("size", TensorValue.scalar(size))
        td.set("checksum", TensorValue.scalar(checksum))
        td.set("content_type", TensorValue.scalar(content_type))
        td.set("creator", TensorValue.scalar(creator))
        td.set("created", TensorValue.scalar(time.time()))
        td.set("tags", TensorValue.pointers([]))
        td.set("links", TensorValue.pointers([]))
        self.store.put(_BLOB + artifact_id, td)
        return artifact_id

    def writer(self, name: str, content_type: Optional[str] = None,
               creator: Optional[str] = None) -> BlobWriter:
        return BlobWriter(self, name, content_type, creator)

    def put(self, name: str, data: bytes,
            content_type: Optional[str] = None,
            creator: Optional[str] = None) -> str:
        w = self.writer(name, content_type, creator)
        w.write(data)
        return w.finish()

    def _artifact(self, artifact_id: str) -> TensorData:
        data = self.store.get(_BLOB + artifact_id)
        if data is None:
            raise BlobError(f"no blob '{artifact_id}'")
        return data

    def get(self, artifact_id: str) -> bytes:
        return b"".join(self.read_stream(artifact_id))

    def read_stream(self, artifact_id: str) -> Iterator[bytes]:
        data = self._artifact(artifact_id)
        for chunk_key in data.get("chunks").value:
            chunk = self.store.get(chunk_key)
            if chunk is None:
                raise BlobError(
                    f"missing chunk {chunk_key} of '{artifact_id}'")
            payload = chunk.get("data").value
            # chunks are content-addressed (the key IS the sha256), so
            # verifying on read costs one hash and turns silent bit-rot
            # into a clean error (tensor_blob integrity.rs semantics)
            if hashlib.sha256(payload).hexdigest() != \
                    chunk_key[len(_CHUNK):]:
                raise BlobError(
                    f"corrupt chunk {chunk_key} of '{artifact_id}' "
                    f"(content hash mismatch)")
            yield payload

    def delete(self, artifact_id: str) -> bool:
        try:
            data = self._artifact(artifact_id)
        except BlobError:
            return False
        for chunk_key in data.get("chunks").value:
            self._unref_chunk(chunk_key[len(_CHUNK):])
        return self.store.delete(_BLOB + artifact_id)

    def info(self, artifact_id: str) -> Dict[str, object]:
        d = self._artifact(artifact_id)
        return {
            "id": artifact_id,
            "name": d.get("name").value,
            "size": d.get("size").value,
            "checksum": d.get("checksum").value,
            "content_type": d.get("content_type").value,
            "creator": d.get("creator").value,
            "created": d.get("created").value,
            "tags": list(d.get("tags").value),
            "links": list(d.get("links").value),
            "chunks": len(d.get("chunks").value),
        }

    def list(self, pattern: Optional[str] = None) -> List[str]:
        ids = [k[len(_BLOB):] for k in self.store.scan(_BLOB)]
        if pattern:
            ids = [i for i in ids
                   if fnmatch(self.info(i)["name"], pattern)]
        return sorted(ids, key=lambda s: int(s.split("-")[1]))

    # -- tags / links / meta ----------------------------------------------------
    def _update(self, artifact_id: str, **lists) -> None:
        d = self._artifact(artifact_id)
        for field_name, values in lists.items():
            d.set(field_name, TensorValue.pointers(values))
        self.store.put(_BLOB + artifact_id, d)

    def tag(self, artifact_id: str, tag: str) -> None:
        tags = set(self.info(artifact_id)["tags"])
        tags.add(tag)
        self._update(artifact_id, tags=sorted(tags))

    def untag(self, artifact_id: str, tag: str) -> None:
        tags = set(self.info(artifact_id)["tags"])
        tags.discard(tag)
        self._update(artifact_id, tags=sorted(tags))

    def link(self, artifact_id: str, entity: str) -> None:
        links = set(self.info(artifact_id)["links"])
        links.add(entity)
        self._update(artifact_id, links=sorted(links))

    def unlink(self, artifact_id: str, entity: str) -> None:
        links = set(self.info(artifact_id)["links"])
        links.discard(entity)
        self._update(artifact_id, links=sorted(links))

    def links(self, artifact_id: str) -> List[str]:
        return self.info(artifact_id)["links"]

    def by_tag(self, tag: str) -> List[str]:
        return [i for i in self.list() if tag in self.info(i)["tags"]]

    def for_entity(self, entity: str) -> List[str]:
        return [i for i in self.list() if entity in self.info(i)["links"]]

    def by_type(self, content_type: str) -> List[str]:
        return [i for i in self.list()
                if self.info(i)["content_type"] == content_type]

    def meta_set(self, artifact_id: str, key: str, value: str) -> None:
        d = self._artifact(artifact_id)
        d.set(f"meta_{key}", TensorValue.scalar(value))
        self.store.put(_BLOB + artifact_id, d)

    def meta_get(self, artifact_id: str, key: str) -> Optional[str]:
        d = self._artifact(artifact_id)
        v = d.get(f"meta_{key}")
        return v.value if v is not None else None

    # -- integrity / GC / stats ---------------------------------------------------
    def verify(self, artifact_id: str) -> bool:
        d = self._artifact(artifact_id)
        sha = hashlib.sha256()
        try:
            for chunk in self.read_stream(artifact_id):
                sha.update(chunk)
        except BlobError:
            return False
        return sha.hexdigest() == d.get("checksum").value

    def gc(self, full: bool = False) -> int:
        """Remove unreferenced chunks; `full` recomputes refcounts."""
        removed = 0
        with self._lock:
            if full:
                live: Dict[str, int] = {}
                for aid in self.list():
                    for ck in self._artifact(aid).get("chunks").value:
                        live[ck] = live.get(ck, 0) + 1
                for ck in self.store.scan(_CHUNK):
                    want = live.get(ck, 0)
                    chunk = self.store.get(ck)
                    if want == 0:
                        self.store.delete(ck)
                        removed += 1
                    elif chunk.get("refs").value != want:
                        td = TensorData()
                        td.set("data",
                               TensorValue.scalar(chunk.get("data").value))
                        td.set("refs", TensorValue.scalar(want))
                        self.store.put(ck, td)
            else:
                for ck in self.store.scan(_CHUNK):
                    chunk = self.store.get(ck)
                    if chunk.get("refs").value <= 0:
                        self.store.delete(ck)
                        removed += 1
        return removed

    def repair(self) -> List[str]:
        """Returns artifact ids failing verification (after full GC)."""
        self.gc(full=True)
        return [aid for aid in self.list() if not self.verify(aid)]

    def stats(self) -> Dict[str, object]:
        ids = self.list()
        total = sum(self.info(i)["size"] for i in ids)
        chunks = self.store.scan_count(_CHUNK)
        return {"count": len(ids), "total_bytes": total,
                "chunks": chunks}
