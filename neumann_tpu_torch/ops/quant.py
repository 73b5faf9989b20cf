"""int8 scalar quantization (the slice's part of
``neumann_tpu/ops/quant.py``).

Per-row symmetric scale (absmax/127), round half to even, clip to
[-127, 127] — the same arithmetic as the JAX package, so an int8 plane
quantized by either package is bit-identical.
"""

from __future__ import annotations

import torch


def scalar_quantize(x: torch.Tensor):
    """Quantize [N, d] f32 -> (int8 [N, d], per-row scale [N] f32)."""
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def scalar_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def int8_cosine_row_mult(corpus_q: torch.Tensor,
                         corpus_scale: torch.Tensor) -> torch.Tensor:
    """Per-row cosine multiplier scale/||row|| (0 = zero row): a unit
    row is ``corpus_q * row_mult``."""
    cn2 = (corpus_q.float() ** 2).sum(dim=1) * corpus_scale ** 2
    return torch.where(cn2 > 0, corpus_scale * torch.rsqrt(
        cn2.clamp_min(1e-30)), torch.zeros_like(cn2))
