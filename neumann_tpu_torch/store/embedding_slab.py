"""Embedding slab with torch device views (port of
``neumann_tpu/store/embedding_slab.py``).

The authoritative host mirror (numpy [capacity, dim_pad] f32 + valid
bitmap), its mutations and the named watchers are the JAX slab's host
half, copied. The views become torch tensors on the slab's device:

* ``device_view`` flushes pending host mutations by scattering the dirty
  rows, or by a full upload past 1/8 of the capacity;
* ``host_int8`` (the IVF build's input) quantizes on the device and
  returns host planes bit-identical to the JAX slab's numpy quantizer,
  on the CPU and on the card;
* ``quantized_view`` ("int8" | "int8c" | "f32c" | "binary") is
  recomputed on device when the slab version moves, and cached by
  version."""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops.quant import (
    binary_quantize,
    f32_cosine_row_mult,
    int8_cosine_row_mult,
    scalar_quantize,
)
from neumann_tpu_torch.ops.rerank import residual_quantize
from neumann_tpu_torch.utils.shapes import LANE, round_up

_MIN_CAPACITY = 1024
# below this fraction of dirty rows, update the device copy by scatter
_SCATTER_FRACTION = 0.125

# rows per device quantization step: bounds the f32 temporaries of
# scalar_quantize to a few hundred MB at 768d
_QUANT_CHUNK_ROWS = 1 << 18
# rows per binary packing step: its int64 temporaries are 8 bytes per
# dimension per row
_BINARY_CHUNK_ROWS = 1 << 16


class EmbeddingSlab:
    def __init__(self, dim: int, min_capacity: int = _MIN_CAPACITY,
                 device="cuda"):
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.dim = dim
        self.dim_pad = round_up(dim, LANE)
        self._capacity = max(_MIN_CAPACITY, min_capacity)
        self._host = np.zeros((self._capacity, self.dim_pad), np.float32)
        self._valid = np.zeros(self._capacity, bool)
        self._lock = threading.RLock()
        self._dirty: set[int] = set()
        self._full_dirty = True
        self._version = 0          # bumps on every mutation
        self._device = None        # torch [capacity, dim_pad]
        self._device_valid = None  # torch [capacity] bool
        self._device_version = -1
        self._quant_cache = {}     # mode -> (version, arrays)
        # named watchers: rows mutated since watch(name) was (re)armed.
        # Lets an index built at version V know exactly which rows went
        # stale (auto-IVF routing) without diffing the whole slab.
        self._watchers: dict = {}
        self.device = torch.device(device)

    # -- watchers ----------------------------------------------------------
    def watch(self, name: str) -> int:
        """(Re)arm a watcher; returns the version it starts from."""
        with self._lock:
            self._watchers[name] = set()
            return self._version

    def watched(self, name: str) -> np.ndarray:
        """Sorted row ids mutated since watch(name). Empty if unarmed."""
        with self._lock:
            rows = self._watchers.get(name)
            if not rows:
                return np.empty(0, np.int64)
            return np.fromiter(sorted(rows), np.int64, count=len(rows))

    def watch_count(self, name: str) -> int:
        with self._lock:
            return len(self._watchers.get(name, ()))

    # -- host mutations ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    def valid_count(self) -> int:
        with self._lock:
            return int(self._valid.sum())

    def _ensure_capacity(self, row: int) -> None:
        if row < self._capacity:
            return
        new_cap = self._capacity
        while new_cap <= row:
            new_cap *= 2
        host = np.zeros((new_cap, self.dim_pad), np.float32)
        host[: self._capacity] = self._host
        valid = np.zeros(new_cap, bool)
        valid[: self._capacity] = self._valid
        self._host, self._valid = host, valid
        self._capacity = new_cap
        self._full_dirty = True
        self._device = None
        self._device_valid = None

    def set_row(self, row: int, vec: np.ndarray) -> None:
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (self.dim,):
            raise ValueError(
                f"dimension mismatch: expected {self.dim}, got {vec.shape}")
        with self._lock:
            self._ensure_capacity(row)
            self._host[row, : self.dim] = vec
            self._host[row, self.dim:] = 0.0
            self._valid[row] = True
            self._dirty.add(row)
            for w in self._watchers.values():
                w.add(row)
            self._version += 1

    def set_rows(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        """Batch insert: rows [B] int, vecs [B, dim]."""
        vecs = np.asarray(vecs, dtype=np.float32)
        rows = np.asarray(rows, dtype=np.int64)
        if vecs.shape != (len(rows), self.dim):
            raise ValueError("batch shape mismatch")
        with self._lock:
            if len(rows):
                self._ensure_capacity(int(rows.max()))
                start = int(rows[0])
                if rows.size > 1 and int(rows[-1]) - start == \
                        rows.size - 1 and bool((np.diff(rows) == 1).all()):
                    # contiguous ascending range: one slice memcpy
                    # instead of fancy indexing (columnar ingest path)
                    end = start + rows.size
                    self._host[start:end, : self.dim] = vecs
                    self._host[start:end, self.dim:] = 0.0
                    self._valid[start:end] = True
                else:
                    self._host[rows, : self.dim] = vecs
                    self._host[rows, self.dim:] = 0.0
                    self._valid[rows] = True
                row_list = rows.tolist()    # C loop, not a genexpr
                self._dirty.update(row_list)
                for w in self._watchers.values():
                    w.update(row_list)
                self._version += 1

    def adopt_matrix(self, matrix: np.ndarray) -> bool:
        """Zero-copy bulk load into an EMPTY slab: take ownership of a
        C-contiguous [N, dim_pad] f32 buffer as rows 0..N-1 instead of
        memcpying it in (~2.8 µs/row at 768d on the bench VM — the
        dominant ingest cost). The caller must not mutate the buffer
        afterwards. Returns False (and changes nothing) when the slab
        already has rows or the buffer shape/layout doesn't match."""
        if (matrix.dtype != np.float32
                or not matrix.flags["C_CONTIGUOUS"]
                or not matrix.flags["WRITEABLE"]
                or matrix.ndim != 2
                or matrix.shape[1] != self.dim_pad
                or matrix.shape[0] < _MIN_CAPACITY):
            return False
        with self._lock:
            if self._valid.any():
                return False
            n = matrix.shape[0]
            self._host = matrix
            self._valid = np.ones(n, bool)
            self._capacity = n
            self._full_dirty = True
            self._device = None
            self._device_valid = None
            rows = range(n)
            for w in self._watchers.values():
                w.update(rows)
            self._version += 1
            return True

    def clear_row(self, row: int) -> None:
        with self._lock:
            if 0 <= row < self._capacity and self._valid[row]:
                self._valid[row] = False
                self._host[row] = 0.0
                self._dirty.add(row)
                for w in self._watchers.values():
                    w.add(row)
                self._version += 1

    def get_row(self, row: int) -> Optional[np.ndarray]:
        with self._lock:
            if 0 <= row < self._capacity and self._valid[row]:
                return self._host[row, : self.dim].copy()
            return None

    def valid_mask_host(self) -> np.ndarray:
        with self._lock:
            return self._valid.copy()

    def rows_matrix(self, rows: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot (matrix [m, dim_pad] f32, valid [m]) of given rows."""
        rows = np.asarray(rows, np.int64)
        with self._lock:
            rows = rows[rows < self._capacity]
            return self._host[rows].copy(), self._valid[rows].copy()

    def host_int8(self, chunk_rows: int = 1 << 20, residual: bool = False):
        """Host int8 planes of the whole slab for IVF builds, as the JAX
        slab returns them — (q, scale) or (q, scale, rq, rscale) numpy
        arrays — but quantized on the slab's device, chunk by chunk, with
        ``scalar_quantize`` / ``residual_quantize`` in the "divide" form
        (the scale absmax / 127 by true division, each value divided by
        it, rounded half to even): the arithmetic of the JAX slab's numpy
        quantizer, so the planes are bit-identical to its on the CPU and
        on the card alike. Where the JAX slab's native C quantizer loads
        (it takes precedence there), its scales are the same but it
        multiplies each value by the reciprocal scale, and a value can
        land one step away at a rounding tie. This replaces a
        single-threaded host pass that took 67.5 s of a 73 s index build
        at 4.19M x 768 (H100 host)."""
        with self._lock:
            host = self._host
            n = self._capacity
        q = np.empty((n, self.dim_pad), np.int8)
        scale = np.empty(n, np.float32)
        rq = np.empty((n, self.dim_pad), np.int8) if residual else None
        rscale = np.empty(n, np.float32) if residual else None
        for s in range(0, n, chunk_rows):
            e = min(n, s + chunk_rows)
            x = torch.from_numpy(host[s:e]).to(self.device)
            qc, sc = scalar_quantize(x, form="divide")
            q[s:e] = qc.cpu().numpy()
            scale[s:e] = sc.cpu().numpy()
            if residual:
                rqc, rsc = residual_quantize(x, qc, sc, form="divide")
                rq[s:e] = rqc.cpu().numpy()
                rscale[s:e] = rsc.cpu().numpy()
        return (q, scale, rq, rscale) if residual else (q, scale)

    def host_snapshot(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """Consistent copy (matrix [capacity, dim_pad] f32, valid
        [capacity] bool, version) for mesh placement: the sharded
        corpus is rebuilt from this when the slab version moves."""
        with self._lock:
            return self._host.copy(), self._valid.copy(), self._version

    @property
    def version(self) -> int:
        return self._version

    def device_view(self):
        """(embeddings [capacity, dim_pad] f32, valid [capacity] bool) on
        the slab's device, flushing pending host mutations. The host
        mirror is always copied, never aliased (a CPU device would
        otherwise share memory with it)."""
        with self._lock:
            if self._device_version == self._version and \
                    self._device is not None:
                return self._device, self._device_valid
            if (self._device is not None and not self._full_dirty
                    and len(self._dirty)
                    <= self._capacity * _SCATTER_FRACTION):
                rows = np.fromiter(self._dirty, np.int64,
                                   count=len(self._dirty))
                idx = torch.from_numpy(rows).to(self.device)
                self._device[idx] = torch.from_numpy(
                    self._host[rows]).to(self.device)
                self._device_valid[idx] = torch.from_numpy(
                    self._valid[rows]).to(self.device)
            else:
                self._device = torch.from_numpy(self._host).to(
                    self.device, copy=True)
                self._device_valid = torch.from_numpy(self._valid).to(
                    self.device, copy=True)
            self._dirty.clear()
            self._full_dirty = False
            self._device_version = self._version
            return self._device, self._device_valid

    def quantized_view(self, mode: str):
        """Device view in a quantized storage mode, cached by version.

        "int8"  -> (values int8 [cap, dim_pad], scale f32 [cap], valid)
        "int8c" -> (values, scale, cosine row multiplier f32 [cap], valid)
        "f32c"  -> (embeddings f32, inverse row norm f32 [cap], valid)
        "binary" -> (sign bits int32 [cap, dim_pad/32], valid): the JAX
                   view's uint32 words as int32 bit patterns
        """
        with self._lock:
            cached = self._quant_cache.get(mode)
            if cached is not None and cached[0] == self._version:
                return cached[1]
            version = self._version
        emb, valid = self.device_view()
        if mode == "int8":
            q = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
            scale = torch.empty(emb.shape[0], dtype=torch.float32,
                                device=emb.device)
            # the reciprocal form: the JAX slab quantizes its device view
            # under jax.jit
            for s in range(0, emb.shape[0], _QUANT_CHUNK_ROWS):
                q[s:s + _QUANT_CHUNK_ROWS], scale[s:s + _QUANT_CHUNK_ROWS] = \
                    scalar_quantize(emb[s:s + _QUANT_CHUNK_ROWS],
                                    form="reciprocal")
            out = (q, scale, valid)
        elif mode == "int8c":
            q, scale, valid = self.quantized_view("int8")
            out = (q, scale, int8_cosine_row_mult(q, scale), valid)
        elif mode == "f32c":
            out = (emb, f32_cosine_row_mult(emb), valid)
        elif mode == "binary":
            bits = torch.empty((emb.shape[0], -(-emb.shape[1] // 32)),
                               dtype=torch.int32, device=emb.device)
            for s in range(0, emb.shape[0], _BINARY_CHUNK_ROWS):
                bits[s:s + _BINARY_CHUNK_ROWS] = binary_quantize(
                    emb[s:s + _BINARY_CHUNK_ROWS])
            out = (bits, valid)
        else:
            raise ValueError(f"unknown quantization mode: {mode}")
        with self._lock:
            self._quant_cache[mode] = (version, out)
        return out
