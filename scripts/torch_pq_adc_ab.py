"""Time the ADC scan's top-k (row 8, ``csrc/pq_adc.cu``) of two or more
checkouts on one card, in turns, on the same inputs.

    python scripts/torch_pq_adc_ab.py --trees build/parent . . build/parent

Each tree runs in a process of its own with that tree's
``neumann_tpu_torch`` (its kernels built from its ``csrc/``), on inputs
made here from ``--seed``: 1,048,576 random codes of 96 subspaces (1 %
dead rows, every eighth row a copy of another: exact ties) with tables for
1,024 queries, and IVFIndex-like gathered candidates (170 queries x 16
probed blocks of 12,280 rows x M 8, a third of each block padding). Per
shape, the top-10 the tree's callers take: where the tree has
``pq_adc_topk`` (the select mode) that launch, else its scores mode and
``_topk_stable`` over the [Q, C] scores (``scores_topk``, timed in every
tree). Shapes: Q 1,024 x 2^20 (a batch's whole top-k; the tree's
``pq_topk`` steps, tables included, as ``pq_topk_ms``), G's step of the
earlier design (Q 85), 8 and 1 queries, H's gathered step (Q 170). Each
result is first held equal to ``_topk_stable`` of the tree's plain scores.
Per shape: ``ms`` by CUDA events over back-to-back calls and
``device_ms``, the calls' kernels summed from torch.profiler. Then G's
whole batch call through the tree's router (cell G): a ``QUANTIZATION
pq`` collection of 1,048,576 rows of a 4,096-centre mixture (768-d, M 96;
the codebook trained on its first SIMILAR), a batch of 1,024 at TOP 10,
wall ms of 4 calls (the median of the last 3) and one call's device time.
Prints one JSON object and writes it to ``chiprun_out/pq_adc_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N, M, K = 1 << 20, 96, 10
SHAPES = (("q1024", 1024), ("g_step", 85), ("q8", 8), ("q1", 1))
H_Q, H_BLOCKS, H_STRIDE, H_PROBES, H_M = 170, 256, 12_280, 16, 8
G_ROWS, G_DIM, G_BATCH = 1 << 20, 768, 1024


def _inputs(seed: int):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 256, (N, M), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[7::8] = codes[torch.randint(0, N, (N // 8,), generator=g,
                                      device=dev)]
    valid = torch.rand(N, generator=g, device=dev) > 0.01
    tables = torch.rand(1024, M, 256, generator=g, device=dev) * 4.0
    hn = H_BLOCKS * H_STRIDE
    hcodes = torch.randint(0, 256, (hn, H_M), generator=g, device=dev,
                           dtype=torch.uint8)
    hvalid = torch.arange(hn, device=dev) % H_STRIDE < 2 * H_STRIDE // 3
    probe = torch.stack([torch.randperm(H_BLOCKS, generator=g,
                                        device=dev)[:H_PROBES]
                         for _ in range(H_Q)])
    hcand = ((probe[:, :, None] * H_STRIDE
              + torch.arange(H_STRIDE, device=dev)).reshape(H_Q, -1).int())
    htables = torch.rand(H_Q, H_M, 256, generator=g, device=dev) * 4.0
    return (codes, valid, tables), (hcodes, hvalid, hcand, htables)


def _device_ms(fn, reps: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in tp.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def _events_ms(fn, reps: int) -> float:
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


def _g_batch(seed: int) -> dict:
    """G's batch call through the tree's router (see the module doc)."""
    import numpy as np
    import torch

    from neumann_tpu_torch.router import QueryRouter

    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((4096, G_DIM), dtype=np.float32)
    x = centres[rng.integers(0, 4096, G_ROWS)]
    x += 0.25 * rng.standard_normal((G_ROWS, G_DIM), dtype=np.float32)
    q = centres[rng.integers(0, 4096, G_BATCH)] + 0.25 * rng.standard_normal(
        (G_BATCH, G_DIM), dtype=np.float32)
    router = QueryRouter(device="cuda")
    eng = router.vector
    router.execute(f"CREATE COLLECTION pq DIM {G_DIM} QUANTIZATION pq")
    with eng.bulk_ingest():
        for i in range(G_ROWS):
            eng.store_in_collection("pq", f"k{i}", x[i])
    del x
    eng.batch_search_ns(q[:1], K, ns="col/pq")   # trains and encodes
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.batch_search_ns(q, K, ns="col/pq")
        times.append((time.perf_counter() - t0) * 1e3)
    return {"wall_ms": times, "median_ms": float(np.median(times[1:])),
            "device_ms": _device_ms(
                lambda: eng.batch_search_ns(q, K, ns="col/pq"), 1)}


def run_tree(seed: int, g_batch: bool) -> dict:
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops import pq as tpq
    from neumann_tpu_torch.ops.scan import _topk_stable

    (codes, valid, tables), (hcodes, hvalid, hcand, htables) = _inputs(seed)
    fused = hasattr(tk, "pq_adc_topk")
    rec = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(0),
           "fused": fused}

    def calls(c, t, v, cand=None):
        scores_topk = lambda: _topk_stable(   # noqa: E731
            tk.pq_adc_scores(c, t, v, cand), K)
        path = ((lambda: tk.pq_adc_topk(c, t, v, K, cand)) if fused
                else scores_topk)
        return path, scores_topk

    cases = [(name, (codes, tables[:q].contiguous(), valid))
             for name, q in SHAPES]
    cases.append(("h_step", (hcodes, htables, hvalid, hcand)))
    for name, args in cases:
        path, scores_topk = calls(*args)
        want = _topk_stable(tk.pq_adc_scores_plain(*args), K)
        got = path()
        torch.cuda.synchronize()
        equal = (torch.equal(got[0], want[0])
                 and torch.equal(got[1].long(), want[1].long()))
        del want, got
        reps = 3 if name in ("q1024",) else 20
        rec[name] = {"equal": equal, "ms": _events_ms(path, reps),
                     "device_ms": _device_ms(path, min(reps, 5)),
                     "scores_topk_ms": _events_ms(scores_topk, reps)}
        torch.cuda.empty_cache()
    # the tree's pq_topk on 1,024 queries: its steps and tables included
    book = tpq.PQCodebook.from_codebooks(
        torch.rand(M, 256, 8, device="cuda").cpu().numpy(), device="cuda")
    qs = torch.randn(1024, M * 8, device="cuda")
    rec["q1024"]["pq_topk_ms"] = _events_ms(
        lambda: tpq.pq_topk(book, codes, qs, K, valid), 3)
    if g_batch:
        rec["g_batch"] = _g_batch(seed)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-batch", action="store_true",
                    help="skip G's batch call through the router")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("AB " + json.dumps(run_tree(args.seed, not args.no_batch)),
              flush=True)
        return 0
    here = os.path.abspath(__file__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        cmd = [sys.executable, here, "--one", "--seed", str(args.seed)]
        if args.no_batch:
            cmd.append("--no-batch")
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(f"tree {tree} failed ({proc.returncode})", flush=True)
            return 1
        runs.append(json.loads(lines[-1]))
        print(f"tree {tree}: " + lines[-1], flush=True)
    out = {"card": smi, "runs": runs}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "pq_adc_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    names = [s[0] for s in SHAPES] + ["h_step"]
    return 0 if all(r[n]["equal"] for r in runs for n in names) else 1


if __name__ == "__main__":
    sys.exit(main())
