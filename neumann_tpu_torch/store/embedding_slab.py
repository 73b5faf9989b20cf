"""Embedding slab with torch device views (port of the device side of
``neumann_tpu/store/embedding_slab.py``).

The authoritative host mirror, watchers and mutations are the JAX
package's ``EmbeddingSlab``, reused by subclassing (that module imports
JAX only inside the views this class overrides). The views become torch
tensors on the slab's device:

* ``device_view`` flushes pending host mutations by scattering the dirty
  rows, or by a full upload past 1/8 of the capacity;
* ``host_int8`` (the IVF build's input) quantizes on the device and
  returns host planes bit-identical to the base class's numpy quantizer;
* ``quantized_view`` ("int8" | "int8c" | "f32c" | "binary") is
  recomputed on device when the slab version moves, and cached by
  version.
"""

from __future__ import annotations

import numpy as np
import torch

from neumann_tpu.store import embedding_slab as _base
from neumann_tpu_torch.ops.quant import (
    binary_quantize,
    f32_cosine_row_mult,
    int8_cosine_row_mult,
    scalar_quantize,
)
from neumann_tpu_torch.ops.rerank import residual_quantize

# rows per device quantization step: bounds the f32 temporaries of
# scalar_quantize to a few hundred MB at 768d
_QUANT_CHUNK_ROWS = 1 << 18
# rows per binary packing step: its int64 temporaries are 8 bytes per
# dimension per row
_BINARY_CHUNK_ROWS = 1 << 16


class EmbeddingSlab(_base.EmbeddingSlab):
    def __init__(self, dim: int, min_capacity: int = _base._MIN_CAPACITY,
                 device="cuda"):
        super().__init__(dim, min_capacity)
        self.device = torch.device(device)

    def host_int8(self, chunk_rows: int = 1 << 20, residual: bool = False):
        """Host int8 planes of the whole slab for IVF builds, as the base
        class returns them — (q, scale) or (q, scale, rq, rscale) numpy
        arrays — but quantized on the slab's device, chunk by chunk, with
        ``scalar_quantize`` / ``residual_quantize`` (absmax/127 scale,
        divide, round half to even). The planes are bit-identical to the
        base class's numpy quantizer; its native C quantizer multiplies
        by the reciprocal scale instead and can land one step away at a
        rounding tie. This replaces a single-threaded host pass that took
        67.5 s of a 73 s index build at 4.19M x 768 (H100 host)."""
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
            qc, sc = scalar_quantize(x)
            q[s:e] = qc.cpu().numpy()
            scale[s:e] = sc.cpu().numpy()
            if residual:
                rqc, rsc = residual_quantize(x, qc, sc)
                rq[s:e] = rqc.cpu().numpy()
                rscale[s:e] = rsc.cpu().numpy()
        return (q, scale, rq, rscale) if residual else (q, scale)

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
                    <= self._capacity * _base._SCATTER_FRACTION):
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
            for s in range(0, emb.shape[0], _QUANT_CHUNK_ROWS):
                q[s:s + _QUANT_CHUNK_ROWS], scale[s:s + _QUANT_CHUNK_ROWS] = \
                    scalar_quantize(emb[s:s + _QUANT_CHUNK_ROWS])
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
