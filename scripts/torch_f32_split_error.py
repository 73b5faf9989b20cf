"""The error of f32 dots formed from split low-precision products, emulated
in plain torch on the CPU, against float64: the choice between the
schemes row 6's tensor-core kernel (``csrc/f32_pooled.cu``) could take.

* ``f32``: one f32 product a term, summed by ``torch.matmul`` (the plain
  version's arithmetic).
* ``tf32x1``: the TF32 parts' big values alone (what the tensor cores do
  with f32 operands and no split).
* ``tf32x3``: ``ops/kernels._tf32_split`` of both operands, small x big,
  big x small, big x big, a stage of 32 K from a fresh zero, then added
  to the running sum (the kernel's order).
* ``bf16x6``: each operand as three bf16 parts (hi, mid, lo), the six
  products hi.hi, hi.mid, mid.hi, mid.mid, hi.lo, lo.hi, a stage of 64 K
  at a time.

On B's recipe (chip_smoke.py's 768-d mixture, queries near rows) at a
CPU size: per scheme the largest error of a dot over sum |x_k c_k|, the
largest error of a cosine, and at pools of 8 and 512 the decoded winners'
largest error and the share of pools whose winning row is the float64
scores' (the tolerance of chip_smoke.py: ``pool * 2**-22 + 1e-6``, at
least 99 % of pools).

    python scripts/torch_f32_split_error.py [--rows 16384] [--queries 64]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from neumann_tpu_torch.ops import kernels as tk  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _staged(parts, stage_k: int, d: int):
    """sum over stages of stage_k K of (the pairs' products summed from a
    fresh zero), each stage added by one rounded f32 add."""
    total = None
    for k0 in range(0, d, stage_k):
        sl = slice(k0, k0 + stage_k)
        stage = None
        for xs, cs in parts:
            p = xs[:, sl] @ cs[:, sl].T
            stage = p if stage is None else stage + p
        total = stage if total is None else total + stage
    return total


def _bf16_parts(x):
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return hi, mid, lo


def schemes(c, x):
    d = c.shape[1]
    bc, sc = tk._tf32_split(c)
    bx, sx = tk._tf32_split(x)
    hc, mc, lc = _bf16_parts(c)
    hx, mx, lx = _bf16_parts(x)
    return {
        "f32": x @ c.T,
        "tf32x1": bx @ bc.T,
        "tf32x3": _staged(((bx, sc), (sx, bc), (bx, bc)), 32, d),
        "bf16x6": _staged(((lx, hc), (hx, lc), (mx, mc), (mx, hc),
                           (hx, mc), (hx, hc)), 64, d),
    }


def _winners(scores, pool: int):
    s = scores.float() + 2.0
    bits = s.view(torch.int32) & ~(pool - 1)
    bits = bits | (torch.arange(scores.shape[1]) & (pool - 1)).int()
    return bits.reshape(scores.shape[0], -1, pool).amax(-1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cs = _chip_smoke()
    root = np.random.SeedSequence(args.seed)
    s_cent, s_rows, s_q = root.spawn(3)
    centres = np.random.default_rng(s_cent).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    c = torch.from_numpy(cs.mixture(args.rows, centres, s_rows))
    x = torch.from_numpy(cs.mixture(args.queries, centres, s_q))
    exact = x.double() @ c.double().T
    scale = x.double().abs() @ c.double().abs().T
    norms = x.double().norm(dim=1)[:, None] * c.double().norm(dim=1)[None]
    cos64 = exact / norms
    out = {"rows": args.rows, "queries": args.queries, "d": cs.DIM,
           "device": "cpu (emulation)"}
    for name, dots in schemes(c, x).items():
        err = (dots.double() - exact).abs()
        cos = dots.double() / norms
        rec = {"max_err_over_sum_abs": float((err / scale).max()),
               "max_cos_err": float((cos - cos64).abs().max())}
        for pool in (8, 512):
            got, want = _winners(cos, pool), _winners(cos64, pool)
            dec = lambda b: (b & ~(pool - 1)).view(torch.float32).double()
            rec[f"pool{pool}_max_winner_err"] = float(
                (dec(got) - dec(want)).abs().max())
            rec[f"pool{pool}_winners_agree"] = float(
                ((got & (pool - 1)) == (want & (pool - 1))).float().mean())
            rec[f"pool{pool}_atol"] = pool * 2.0 ** -22 + 1e-6
        out[name] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
