"""Time the selection steps that order equal scores as ``lax.top_k`` does
against the ``torch.topk`` calls they replaced, at the shapes of cells A,
B and C (chip_smoke.py), on one CUDA card, for one or more checkouts,
each in a process of its own, in the order given:

    python scripts/torch_ties_cost.py --trees build/other . . build/other

Each step is timed four ways:

* ``old``: one ``torch.topk`` (order of equal scores open);
* ``sort``: the tree's selection with ``ops/scan._SORT_MAX`` above the
  step's size: one stable descending sort of the whole [Q, N] plane's
  int32 image, cut to k;
* ``large``: the tree's selection with ``_SORT_MAX`` 0: what it does
  above ``_SORT_MAX`` (in this checkout a ``torch.topk`` of int64 keys);
* ``new``: the tree's selection as it runs (``_SORT_MAX`` as set).

The tree's selection is its ``ops/scan._topk`` where it has one (the
f32 steps; a tree that selects otherwise for large planes), else its
``_topk_stable``; ``_int_topk_stable`` for int32 bits. Steps: ``rerank``
(top-10 of 80 candidates, B / C singles and a batch of 1,024),
``pooled_cut`` (80 of 2,048 pool winners, int32 bits), ``presel`` (A's
batched presel, 32 of 512 packed candidates, 1,024 queries),
``ivf_cut`` (A's single, 56 of 82,944 window scores; 64 queries),
``exact`` (the exact scan's top-10 of 1,048,576 scores, 1 and 4
queries; a blockwise step of 1,024 queries x 65,536). Each on seeded
random values with no exact ties (``free``) and on rows where each value
stands 3 times in a row (``dup``: every top-10 and top-56 then has
equal scores across its k-th place). Each: the host clock of one call
ending in a synchronise (what a query sees, launches included; median
of 200 after 20 warm-up calls) and the device time by CUDA events over
200 calls.

Then the whole exact scan as the engine calls it (``topk_scan``, top-10
euclidean, d 768; 10 warm-up, 30 timed): 262,144 rows (one flat plane)
at 64 queries, and 1,048,576 rows (16 blocks of 65,536) at 64 and 1,024
queries, on ``free`` rows and on ``dup`` rows (each stored 3 times in a
row); ``ties`` counts the queries whose 10th and 11th scores are equal.

Prints one JSON object (with the card's name and power limit) and writes
it to chiprun_out/ties_cost.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = 3


def _timed(fn, reps: int = 200, warm: int = 20) -> dict:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"host_ms": statistics.median(host),
            "device_ms": start.elapsed_time(end) / reps}


def run_tree() -> dict:
    import torch

    from neumann_tpu_torch.ops import scan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(q, n, dup=False):
        if not dup:
            return torch.rand((q, n), generator=g, device=dev)
        base = torch.rand((q, -(-n // COPIES)), generator=g, device=dev)
        return base.repeat_interleave(COPIES, dim=1)[:, :n].contiguous()

    def bits(q, n, dup=False):
        m = -(-n // COPIES) if dup else n
        b = torch.randint(1 << 29, 1 << 30, (q, m), generator=g,
                          device=dev, dtype=torch.int32)
        return (b.repeat_interleave(COPIES, dim=1)[:, :n].contiguous()
                if dup else b)

    f32 = getattr(scan, "_topk", scan._topk_stable)
    steps = {
        "rerank_q1": (rand, 1, 80, 10, scan._topk_stable),
        "rerank_q1024": (rand, 1024, 80, 10, scan._topk_stable),
        "pooled_cut_q1": (bits, 1, 2048, 80, scan._int_topk_stable),
        "pooled_cut_q1024": (bits, 1024, 2048, 80, scan._int_topk_stable),
        "presel_q1024": (rand, 1024, 512, 32, f32),
        "ivf_cut_q1": (rand, 1, 82_944, 56, f32),
        "ivf_cut_q64": (rand, 64, 82_944, 56, f32),
        "exact_q1": (rand, 1, 1 << 20, 10, f32),
        "exact_q4": (rand, 4, 1 << 20, 10, f32),
        "exact_block_q1024": (rand, 1024, 1 << 16, 10, f32),
    }
    default = scan._SORT_MAX
    out = {"sort_max": default, "steps": {}, "scans": {}}
    for name, (make, q, n, k, fn) in steps.items():
        for data in ("free", "dup"):
            x = make(q, n, data == "dup")
            rec = {"old": _timed(lambda: torch.topk(x, k, dim=1))}
            for way, limit in (("sort", 1 << 62), ("large", 0),
                               ("new", default)):
                scan._SORT_MAX = limit
                rec[way] = _timed(lambda: fn(x, k))
            scan._SORT_MAX = default
            out["steps"][f"{name}_{data}"] = rec
            del x
    d = 768
    for rows, q in ((1 << 18, 64), (1 << 20, 64), (1 << 20, 1024)):
        for data in ("free", "dup"):
            m = -(-rows // COPIES) if data == "dup" else rows
            corpus = torch.randn((m, d), generator=g, device=dev)
            if data == "dup":
                corpus = corpus.repeat_interleave(COPIES, dim=0)[:rows]
            queries = torch.randn((q, d), generator=g, device=dev)
            s11 = scan.topk_scan(corpus, queries, 11, "euclidean")[0]
            rec = _timed(lambda: scan.topk_scan(corpus, queries, 10,
                                                "euclidean"),
                         reps=30, warm=10)
            rec["ties"] = int((s11[:, 9] == s11[:, 10]).sum())
            out["scans"][f"scan_n{rows}_q{q}_{data}"] = rec
            del corpus, queries
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("COST " + json.dumps(run_tree()), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_ties_cost: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for tree in args.trees:
        root = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln[5:] for ln in proc.stdout.splitlines()
                 if ln.startswith("COST ")]
        if proc.returncode != 0 or not lines:
            print(f"tree {tree} failed ({proc.returncode})", flush=True)
            return 1
        runs.append(dict(tree=tree, **json.loads(lines[-1])))
    res = {"card": smi, "torch": torch.__version__, "runs": runs}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ties_cost.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
