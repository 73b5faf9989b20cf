"""Count the torch operators one single SIMILAR dispatches on the routes of
cells A, B and C (auto-IVF, f32 pooled, int8 pooled + rerank), for two or
more checkouts, on the CPU at a small size.

    python scripts/torch_ties_ops.py --trees build/parent .

Each tree runs in a process of its own with its own ``neumann_tpu_torch``
on the path: 16,384 x 64 clustered rows (the pooled gate lowered with
``NEUMANN_POOLED_MIN_ROWS`` / ``MIN_POOLS``, an auto-IVF threshold of
8,000 rows), two warm-up queries, then ``torch.profiler`` over 10
queries; prints the ``aten::`` operators a query (each one a host
dispatch, and on a card most of them a kernel launch) in total and by
name, and, between the first tree and each other one, the names whose
count moved. A count of what the program runs, not a time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N, D, Q = 16_384, 64, 10


def run_tree() -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from neumann_tpu_torch.engines.vector import (
        VectorCollectionConfig,
        VectorEngine,
        VectorEngineConfig,
    )

    rng = np.random.default_rng(0)
    cents = rng.standard_normal((64, D)).astype(np.float32) * 3
    x = (cents[rng.integers(0, 64, N)]
         + 0.3 * rng.standard_normal((N, D))).astype(np.float32)
    out = {}
    for cell, cfg, quant in (
            ("A", dict(ivf_auto_threshold=8000, ivf_auto_clusters=32,
                       ivf_auto_nprobe=8), None),
            ("B", {}, None), ("C", {}, "int8")):
        eng = VectorEngine(config=VectorEngineConfig(**cfg), device="cpu")
        if quant:
            eng.create_collection("c", VectorCollectionConfig(
                dimension=D, quantization=quant))
            with eng.bulk_ingest():
                for i in range(N):
                    eng.store_in_collection("c", f"k{i}", x[i])

            def query(q, eng=eng):
                return eng.search_in_collection("c", q, 10)
        else:
            eng.ingest_matrix([f"k{i}" for i in range(N)], x)

            def query(q, eng=eng):
                return eng.search_similar(q, 10)
        route = eng.search_route("col/c" if quant else "", D, 10, "cosine",
                                 None, quant or "none")["route"]
        query(x[0])
        query(x[1])
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(Q):
                query(x[i] + 0.01)
        ops = {e.key: e.count / Q for e in prof.key_averages()
               if e.key.startswith("aten::")}
        out[cell] = {"route": route, "ops": sum(ops.values()),
                     "by_name": ops}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("OPS " + json.dumps(run_tree()), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        root = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"], cwd=root,
            env=dict(os.environ, PYTHONPATH=root,
                     NEUMANN_POOLED_MIN_ROWS="1024",
                     NEUMANN_POOLED_MIN_POOLS="64"),
            capture_output=True, text=True)
        lines = [ln[4:] for ln in proc.stdout.splitlines()
                 if ln.startswith("OPS ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"tree {tree} failed ({proc.returncode})")
            return 1
        runs.append((tree, json.loads(lines[-1])))
    first = runs[0][1]
    report = {"trees": [t for t, _ in runs],
              "ops_a_query": {t: {c: r[c]["ops"] for c in r}
                              for t, r in runs},
              "routes": {c: first[c]["route"] for c in first}, "moved": {}}
    for tree, rec in runs[1:]:
        report["moved"][tree] = {
            c: {k: rec[c]["by_name"].get(k, 0) - first[c]["by_name"].get(k, 0)
                for k in set(rec[c]["by_name"]) | set(first[c]["by_name"])
                if rec[c]["by_name"].get(k, 0)
                != first[c]["by_name"].get(k, 0)}
            for c in rec}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
