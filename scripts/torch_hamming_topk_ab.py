"""Time the port's fused hamming top-k (row 7, ``csrc/hamming_topk.cu``)
of two or more checkouts on one card, in turns, on the same inputs.

    python scripts/torch_hamming_topk_ab.py --trees build/parent . . build/parent

Each tree runs in a process of its own with that tree's
``neumann_tpu_torch`` (its kernels built from its ``csrc/``), on inputs
made here from ``--seed``: D's corpus (1,048,576 rows of 768-d sign bits,
24 words, from a 4,096-centre mixture as chip_smoke.py's, 1 % dead rows)
at Q 1,024, 32, 8 and 1, and E's (262,144 rows of random 96-word bits,
every fourth row a copy of an earlier one, 1 % dead) at Q 256 and 1, and
Q 64 x 131,072 x 96; k 10. Each shape is first held equal to the tree's
plain top-k. Per shape: ``device_ms``, the kernel's own time from
torch.profiler (the kernel named hamming_topk_kernel, nothing else);
``ms``, the wrapper by CUDA events (back-to-back calls: at one query the
host's launch rate); and where the tree has the measurement entry,
``unselected_ms``, the kernel's time with nothing selected. Prints one
JSON object and writes it to ``chiprun_out/hamming_topk_ab.json``; with
``--ptxas`` the first tree also prints nvcc's register and
shared-memory report.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (("d_q1024", "d", 1024), ("d_q32", "d", 32), ("d_q8", "d", 8),
          ("d_q1", "d", 1), ("e_q256", "e", 256), ("e_q1", "e", 1),
          ("w96_q64", "w96", 64))
TOP_K = 10


def _corpora(seed: int):
    import torch

    from neumann_tpu_torch.ops.quant import binary_quantize

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn(4096, 768, generator=g, device=dev)
    n = 1 << 20
    x = torch.empty(n, 768, device=dev)
    for r0 in range(0, n, 1 << 17):
        idx = torch.randint(0, 4096, (1 << 17,), generator=g, device=dev)
        x[r0:r0 + (1 << 17)] = centres[idx] + 0.25 * torch.randn(
            1 << 17, 768, generator=g, device=dev)
    qs = centres[torch.randint(0, 4096, (1024,), generator=g, device=dev)] \
        + 0.25 * torch.randn(1024, 768, generator=g, device=dev)
    d = (binary_quantize(x), binary_quantize(qs),
         torch.rand(n, generator=g, device=dev) > 0.01)
    del x

    def bits(rows):
        return torch.randint(-(1 << 31), 1 << 31, (rows, 96), generator=g,
                             device=dev, dtype=torch.int64).int()

    ne = 1 << 18
    cb = bits(ne)
    cb[3::4] = cb[torch.randint(0, ne, (ne // 4,), generator=g, device=dev)]
    qb = (cb[torch.randint(0, ne, (256,), generator=g, device=dev)]
          ^ (bits(256) & bits(256) & bits(256)))
    e = (cb, qb, torch.rand(ne, generator=g, device=dev) > 0.01)
    return {"d": d, "e": e, "w96": (cb[:1 << 17], qb, e[2][:1 << 17])}


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
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "hamming_topk_kernel" in e.name)
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


def _unselected(tk, cb, qb, mask):
    """A call of the tree's launch with nothing selected, or None where
    the tree has no such entry."""
    import torch

    n, w = cb.shape
    q = qb.shape[0]
    if hasattr(tk, "_hamming_topk_launch"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = tk._hamming_groups(n, q, w, TOP_K, sms)
        out = torch.empty((q, plan[4] * plan[1] * TOP_K), dtype=torch.int64,
                          device=cb.device)
        gthr = torch.empty(q, dtype=torch.int64, device=cb.device)
        return lambda: tk._hamming_topk_launch(cb, qb, mask, TOP_K, plan, out,
                                               gthr, select=False)
    lib = tk.build_kernels()
    groups, span = tk._hamming_groups(n, q, w, cb.device)
    out = torch.empty((q, groups * TOP_K), dtype=torch.int64,
                      device=cb.device)
    return lambda: tk._raise_on(lib.neumann_hamming_topk_unselected(
        cb.data_ptr(), qb.data_ptr(), mask.data_ptr(), out.data_ptr(), n, q,
        w, TOP_K, span, groups, tk._stream()), "hamming_topk")


def run_tree(seed: int, ptxas: bool) -> dict:
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    if ptxas:
        tk.build_kernels(verbose=True)
    data = _corpora(seed)
    rec = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(0)}
    for name, corpus, q in SHAPES:
        cb, qb_all, mask = data[corpus]
        qb = qb_all[:q].contiguous()
        got = tk.hamming_topk(cb, qb, mask, TOP_K)
        want = tk.hamming_topk_plain(cb, qb, mask, TOP_K)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        reps = 20 if q > 1 else 200
        wrapper = lambda: tk.hamming_topk(cb, qb, mask, TOP_K)   # noqa: E731
        r = {"equal": equal, "device_ms": _device_ms(wrapper, reps),
             "ms": _events_ms(wrapper, reps)}
        unsel = _unselected(tk, cb, qb, mask)
        r["unselected_ms"] = _device_ms(unsel, reps)
        rec[name] = r
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("AB " + json.dumps(run_tree(args.seed, args.ptxas)), flush=True)
        return 0
    here = os.path.abspath(__file__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        cmd = [sys.executable, here, "--one", "--seed", str(args.seed)]
        if args.ptxas and i == 0:
            cmd.append("--ptxas")
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if args.ptxas and i == 0:
            print("\n".join(ln for ln in proc.stdout.splitlines()
                            if "hamming_topk" in ln or "ptxas" in ln
                            and ("registers" in ln or "spill" in ln))[-6000:])
        if proc.returncode != 0 or not lines:
            print(f"tree {tree} failed ({proc.returncode})", flush=True)
            return 1
        runs.append(json.loads(lines[-1]))
    out = {"card": smi, "runs": runs}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "hamming_topk_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if all(r[s[0]]["equal"] for r in runs for s in SHAPES) else 1


if __name__ == "__main__":
    sys.exit(main())
