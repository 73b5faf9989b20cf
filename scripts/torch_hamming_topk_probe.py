"""Split the fused hamming top-k's launch (``csrc/hamming_topk.cu``) on a
card by building variants of its source with parts switched off, and by
launching it with other plans, on the same inputs.

    python scripts/torch_hamming_topk_probe.py

Variants (each a patched copy of the source under ``build/probe/``, built
with nvcc into a library of its own): ``full`` as committed;
``no_products``, the consumers skip the K loop (no A or B loads, no
products); ``no_popc``, the helper warps skip the row popcounts;
``pipeline``, both; ``spin``, every mbarrier wait a ``test_wait`` loop
instead of ``try_wait`` (``spin_pipeline`` with no products or
popcounts); ``hint``, ``try_wait`` with a 20 ns suspend hint; ``timed``,
clock64 around each warp role's mbarrier waits (clocks a stage waiting
and in all, for consumers, helpers and the producer). Each runs with
nothing selected (``neumann_hamming_topk_unselected``), and ``full``,
``spin`` and ``hint`` with selection too, at D's shapes (1,048,576 rows
x 24 words, Q 1,024 and 1) and E's (262,144 x 96, Q 256 and 1), random
bits, k 10. Then ``full`` under other plans: D's batch over rows a warp
and stages, one query on D and E over row slices, rows a warp and the
most stages that fit; and the 1-bit product's clocks a dependent step,
one warp a SM with 1 or 8 independent accumulators (its latency, and
the interval between independent products). Times are CUDA events over
back-to-back launches. Prints one JSON object and writes it to
``chiprun_out/hamming_topk_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PATCHES = {
    "no_products": [("    for (int s = 0; s < steps; ++s) {\n      const uint4 av",
                     "    for (int s = 0; s < 0; ++s) {\n      const uint4 av")],
    "no_popc": [("for (int c = c0; c < w / 4; c += lpr)",
                 "for (int c = c0; c < 0; c += lpr)")],
    # mbarrier waits: a test_wait spin, or try_wait with a suspend hint
    "spin": [("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;",
              "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;")],
    "hint": [("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;",
              "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 20;")],
}
# `timed`: clock64 around each role's mbarrier waits, summed over the
# launch into the (otherwise unused) threshold scratch of an unselected
# launch: [0] consumer wait clocks, [1] consumer clocks, [2-3] helpers',
# [4-5] the producer's
_ADD = ("atomicAdd(reinterpret_cast<unsigned long long*>(a.gthr) + {i}, "
        "static_cast<unsigned long long>({v}));")
PATCHES["timed"] = [
    ("      if (it >= a.stages) bar_wait(empty + st, (it / a.stages - 1) & 1);",
     "      { long long t_ = clock64(); if (it >= a.stages) bar_wait(empty + "
     "st, (it / a.stages - 1) & 1); w_ += clock64() - t_; }"),
    ("      bar_wait(full + st, (it / a.stages) & 1);",
     "      { long long t_ = clock64(); bar_wait(full + st, (it / a.stages) "
     "& 1); w_ += clock64() - t_; }"),
    ("    bar_wait(kOwnCounts ? full + st : ready + st, parity);",
     "    { long long t_ = clock64(); bar_wait(kOwnCounts ? full + st : "
     "ready + st, parity); w_ += clock64() - t_; }"),
    ("  if (warp == kConsumers + kHelpers) {",
     "  long long w_ = 0; const long long t0_ = clock64();\n"
     "  if (warp == kConsumers + kHelpers) {"),
    ("    return;\n  }\n  if (warp >= kConsumers) {",
     "    if (lane == 0) { " + _ADD.format(i=4, v="w_") + _ADD.format(
         i=5, v="clock64() - t0_") + " }\n"
     "    return;\n  }\n  if (warp >= kConsumers) {"),
    ("    return;\n  }\n  if (warp >= warps) return;",
     "    if (lane == 0) { " + _ADD.format(i=2, v="w_") + _ADD.format(
         i=3, v="clock64() - t0_") + " }\n"
     "    return;\n  }\n  if (warp >= warps) return;"),
    ("  for (int i = lane; i < kTileQ * a.k; i += 32) {",
     "  if (lane == 0) { " + _ADD.format(i=0, v="w_") + _ADD.format(
         i=1, v="clock64() - t0_") + " }\n"
     "  for (int i = lane; i < kTileQ * a.k; i += 32) {"),
]
VARIANTS = {"full": (), "no_products": ("no_products",),
            "no_popc": ("no_popc",), "pipeline": ("no_products", "no_popc"),
            "spin": ("spin",), "spin_pipeline": ("spin", "no_products",
                                                 "no_popc"),
            "hint": ("hint",), "timed": ("timed",)}
TOP_K = 10


def build(name: str, patches) -> ctypes.CDLL:
    from neumann_tpu_torch.ops import kernels as tk

    src = (tk.CSRC_DIR / "hamming_topk.cu").read_text()
    for p in patches:
        for old, new in PATCHES[p]:
            if old not in src:
                raise RuntimeError(f"patch {p} does not apply: {old[:40]}")
            src = src.replace(old, new)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"hamming_topk_{name}.cu"
    cu.write_text(src)
    so = out / f"lib_{name}.so"
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-I", str(tk.CSRC_DIR),
                    "-shared", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in ("neumann_hamming_topk", "neumann_hamming_topk_unselected"):
        getattr(lib, fn).argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                     i64, i32, i32, i32, i32, i32, vp]
        getattr(lib, fn).restype = i32
    return lib


# the 1-bit product's latency and rate: one warp a block, `chains`
# independent accumulators, `iters` dependent products each
CHAIN_SRC = r"""
#include "mma_b1.cuh"
extern "C" __global__ void b1_chain(int iters, int* out) {
  const unsigned x = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const unsigned a[4] = {x, ~x, x * 3u, x ^ 5u};
  const unsigned b[2] = {x * 7u, x ^ 9u};
  int c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) neumann::mma_b1(c[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][3];
  out[blockIdx.x * 32 + threadIdx.x] = s;
}
extern "C" int launch_chain(int blocks, int iters, void* out) {
  b1_chain<<<blocks, 32>>>(iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def chain_ms(chains: int, blocks: int, iters: int) -> float:
    """Time of `blocks` one-warp blocks of `chains` x `iters` products."""
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"chain{chains}.cu"
    cu.write_text(CHAIN_SRC.replace("CHAINS", str(chains)))
    so = out / f"libchain{chains}.so"
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-I", str(tk.CSRC_DIR),
                    "-shared", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.launch_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sink = torch.empty(blocks * 32, dtype=torch.int32, device="cuda")
    return events_ms(lambda: lib.launch_chain(blocks, iters,
                                              sink.data_ptr()), 5)


def events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launcher(lib, select, cb, qb, mask, plan, scratch=False):
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    (n, w), q = cb.shape, qb.shape[0]
    tiles, slices, rw, stages, groups, span = plan
    out = torch.empty((q, groups * slices * TOP_K), dtype=torch.int64,
                      device=cb.device)
    gthr = torch.empty(max(q, 8), dtype=torch.int64, device=cb.device)
    entry = (lib.neumann_hamming_topk if select
             else lib.neumann_hamming_topk_unselected)

    def run():
        tk._raise_on(entry(cb.data_ptr(), qb.data_ptr(), mask.data_ptr(),
                           out.data_ptr(), gthr.data_ptr(), n, q, w, TOP_K,
                           span, groups, tiles, slices, rw, stages,
                           tk._stream()), "hamming_topk")
    return (run, gthr) if scratch else run


def main() -> int:
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)

    def bits(rows, w):
        return torch.randint(-(1 << 31), 1 << 31, (rows, w), generator=g,
                             device=dev, dtype=torch.int64).int()

    shapes = {}
    for name, n, w, qs in (("d", 1 << 20, 24, (1024, 1)),
                           ("e", 1 << 18, 96, (256, 1))):
        cb = bits(n, w)
        mask = torch.rand(n, generator=g, device=dev) > 0.01
        for q in qs:
            shapes[f"{name}_q{q}"] = (cb, bits(q, w), mask)
    libs = {v: build(v, p) for v, p in VARIANTS.items()}
    rec = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for sname, (cb, qb, mask) in shapes.items():
        (n, w), q = cb.shape, qb.shape[0]
        plan = tk._hamming_groups(n, q, w, TOP_K, sms)
        r = {"plan": plan}
        reps = 20 if q > 1 else 200
        for v, lib in libs.items():
            if v == "timed":
                continue
            r[f"{v}_unselected_ms"] = events_ms(
                launcher(lib, False, cb, qb, mask, plan), reps)
        # clocks a stage: summed over the launch's warps and stages
        run, gthr = launcher(libs["timed"], False, cb, qb, mask, plan,
                             scratch=True)
        gthr.zero_()
        run()
        torch.cuda.synchronize()
        tot = gthr[:6].double().tolist()
        n_it = -(-plan[5] // (plan[1] * plan[2]))
        blocks = plan[4] * -(-q // (16 * plan[0]))
        per = [blocks * plan[0] * plan[1] * n_it, blocks * 4 * n_it,
               blocks * n_it]
        r["timed_clocks_a_stage"] = {
            role: {"wait": tot[2 * i] / per[i], "all": tot[2 * i + 1] / per[i]}
            for i, role in enumerate(("consumer", "helper", "producer"))}
        for v in ("full", "spin", "hint"):
            r[f"{v}_ms"] = events_ms(launcher(libs[v], True, cb, qb, mask,
                                              plan), reps)
        rec[sname] = r
    cb, qb, mask = shapes["d_q1024"]
    (n, w), q = cb.shape, qb.shape[0]
    plans = {}
    for rw in (64, 32, 16):
        for stages in (3, 8, 16):
            rows = rw
            passes = -(-n // rows)
            groups = min(passes, max(1, sms // 8))
            span = min(tk._ht_max_span(w), -(-passes // groups) * rows)
            plan = (8, 1, rw, stages, -(-n // span), span)
            if tk._ht_smem(w, TOP_K, *plan[:4]) > tk._HT_SMEM:
                continue
            plans[f"rw{rw}_st{stages}"] = events_ms(
                launcher(libs["full"], False, cb, qb, mask, plan), 20)
    rec["d_q1024_plans_unselected_ms"] = plans
    # one query: one tile, 8 or 4 row slices, rows a warp 8-32, the most
    # stages that fit
    for sname in ("d_q1", "e_q1"):
        cb, qb, mask = shapes[sname]
        (n, w), q = cb.shape, qb.shape[0]
        plans = {}
        for slices in (8, 4):
            for rw in (32, 16, 8):
                rows = slices * rw
                if rows > 128:
                    continue
                fits = [st for st in range(3, 17) if tk._ht_smem(
                    w, TOP_K, 1, slices, rw, st) <= tk._HT_SMEM]
                if not fits:
                    continue
                passes = -(-n // rows)
                groups = min(passes, sms)
                span = min(tk._ht_max_span(w), -(-passes // groups) * rows)
                plan = (1, slices, rw, fits[-1], -(-n // span), span)
                plans[f"s{slices}_rw{rw}_st{fits[-1]}"] = events_ms(
                    launcher(libs["full"], True, cb, qb, mask, plan), 200)
        rec[f"{sname}_plans_ms"] = plans
    # clocks a product: one warp on each of 132 SMs, 1 or 8 chains
    iters = 1 << 14
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3
    for chains in (1, 8):
        ms = chain_ms(chains, sms, iters)
        rec[f"b1_chain{chains}_clocks_per_step"] = ms * 1e-3 * clock_hz / iters
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "hamming_topk_probe.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
