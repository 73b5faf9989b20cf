"""Time the port's f32 pooled-bits scan (row 6, ``csrc/f32_pooled.cu``)
of two or more checkouts on one card, in turns, on the same inputs.

    python scripts/torch_f32_pooled_ab.py --trees build/parent . . build/parent

Each tree runs in a process of its own with that tree's
``neumann_tpu_torch`` (its kernels built from its ``csrc/``), on inputs
made on the card from ``--seed``: B's corpus (1,048,576 rows of 768-d
from a 4,096-centre mixture, sigma 0.25 as chip_smoke.py's, 1 % dead,
cosine multipliers) at pool 512 and Q 1,024 (B's batch), 128, 64, 32,
17 and 8, and F's FIND launch (the first 262,144 rows, pool 128, one
query). Each shape is first held to the tree's plain version within
chip_smoke.py's tolerance (``pool * 2**-22 + 1e-6``, the winning rows
equal on >= 99 % of live pools, liveness equal). Per shape:
``kernel_ms``, the hand kernel's own time from torch.profiler (its
kernels by name); ``device_ms``, all device time of a call (the query
parts' split included); ``ms``, the call by CUDA events (back-to-back
calls: at one query the host's launch rate). Beside them, once per tree:
``torch.matmul`` of the same product with TF32 off (B's batch; F's with
the pool ``.amax``) and, for information, one TF32 pass. With
``--ptxas`` the first tree also prints nvcc's register and shared-memory
report. Prints one JSON object and writes it to
``chiprun_out/f32_pooled_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

SHAPES = (("b_q1024", "b", 1024), ("b_q128", "b", 128), ("b_q64", "b", 64),
          ("b_q32", "b", 32), ("b_q17", "b", 17), ("b_q8", "b", 8),
          ("f_q1", "f", 1))
POOLS = {"b": 512, "f": 128}
KERNEL = re.compile(r"stream_kernel|batch_kernel|tf32_kernel")


def _data(seed: int):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn(4096, 768, generator=g, device=dev)
    n = 1 << 20
    x = torch.empty(n, 768, device=dev)
    for r0 in range(0, n, 1 << 17):
        idx = torch.randint(0, 4096, (1 << 17,), generator=g, device=dev)
        x[r0:r0 + (1 << 17)] = centres[idx] + 0.25 * torch.randn(
            1 << 17, 768, generator=g, device=dev)
    qs = x[torch.randint(0, n, (1024,), generator=g, device=dev)] \
        + 0.1 * torch.randn(1024, 768, generator=g, device=dev)
    rm = 1.0 / x.norm(dim=1)
    qm = 1.0 / qs.norm(dim=1)
    bias = torch.where(torch.rand(n, generator=g, device=dev) < 0.99,
                       torch.full((n,), 2.0, device=dev),
                       torch.full((n,), -1e30, device=dev))
    f = 1 << 18
    return {"b": (x, rm, bias, qs, qm),
            "f": (x[:f], rm[:f], bias[:f], qs, qm)}


def _device_ms(fn, reps: int, only=None) -> float:
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
             and (only is None or only.search(e.name)))
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


def _check(got, want, pool: int) -> dict:
    import torch

    live = want > 0
    dec = lambda b: (b & ~(pool - 1)).view(torch.float32).double()
    err = float((dec(got) - dec(want)).abs()[live].max())
    agree = float(((got & (pool - 1)) == (want & (pool - 1)))[live]
                  .float().mean())
    ok = (torch.equal(got > 0, live) and torch.equal(got[~live], want[~live])
          and err <= pool * 2.0 ** -22 + 1e-6 and agree >= 0.99)
    return {"ok": bool(ok), "max_abs_err": err, "winners_agree": agree}


def run_tree(seed: int, ptxas: bool) -> dict:
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    if ptxas:
        tk.build_kernels(verbose=True)
    data = _data(seed)
    rec = {"tree": os.getcwd(), "device": torch.cuda.get_device_name(0)}
    for name, corpus, q in SHAPES:
        x, rm, bias, qs_all, qm_all = data[corpus]
        pool = POOLS[corpus]
        qs, qm = qs_all[:q].contiguous(), qm_all[:q].contiguous()
        args = (x, rm, bias, qs, qm, pool)
        got = tk.f32_pooled_bits(*args)
        want = tk.f32_pooled_bits_plain(*args)
        torch.cuda.synchronize()
        r = _check(got, want, pool)
        del got, want
        reps = 5 if q > 64 else (20 if q > 1 else 200)
        call = lambda: tk.f32_pooled_bits(*args)   # noqa: E731
        r.update(kernel_ms=_device_ms(call, reps, KERNEL),
                 device_ms=_device_ms(call, reps), ms=_events_ms(call, reps))
        rec[name] = r
    torch.backends.cuda.matmul.allow_tf32 = False
    x, _, _, qs, _ = data["b"]
    rec["matmul_ms_b_q1024"] = _events_ms(lambda: torch.matmul(qs, x.t()), 5)
    xf = data["f"][0]
    rec["matmul_amax_ms_f_q1"] = _events_ms(
        lambda: torch.matmul(qs[:1], xf.t()).view(1, -1, 128).amax(-1), 200)
    torch.backends.cuda.matmul.allow_tf32 = True
    rec["matmul_tf32_one_pass_ms_b_q1024"] = _events_ms(
        lambda: torch.matmul(qs, x.t()), 5)
    torch.backends.cuda.matmul.allow_tf32 = False
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
                            if "f32_pooled" in ln or "ptxas" in ln
                            and ("registers" in ln or "spill" in ln))[-6000:])
        if proc.returncode != 0 or not lines:
            print(f"tree {tree} failed ({proc.returncode})", flush=True)
            return 1
        runs.append(json.loads(lines[-1]))
    out = {"card": smi, "runs": runs}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "f32_pooled_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if all(r[s[0]]["ok"] for r in runs for s in SHAPES) else 1


if __name__ == "__main__":
    sys.exit(main())
