#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 21 alone on one NVIDIA card: the rows
and queries phase 7 generates from ``--seed``, B's single-query p50 and
batch QPS on one router in this process (rows through
``ingest_matrix``, 64 ``SIMILAR … TOP 10`` and a batch of 1,024), then
phase 21 unchanged: the same rows on a mesh of four logical devices of
the card, SIMILAR served by the engine's mesh placements, rows 2, 4 and
5 held to their plain versions at the shards' launches. ``--device
cpu`` rehearses the control flow without the card (no launch checks).

Usage, from the root of a checkout::

    python scripts/torch_mesh_phase.py [--seed 0] [--rows 1048576]
        [--device cuda]

Writes chiprun_out/mesh_phase.json and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=cs.POOLED_ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    dev = torch.device(args.device)
    t_start = time.perf_counter()
    if on_card:
        tk.build_kernels()
    # chip_smoke.run's draws: centres from the first spawn, phases 7-9's
    # rows and queries from the second
    root = np.random.SeedSequence(args.seed)
    s_centres, _, _ = root.spawn(3)
    s_corpus, s_queries = root.spawn(2)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    corpus = cs.mixture(args.rows, centres, s_corpus)
    queries = cs.mixture(cs.N_SINGLE + cs.N_BATCH + cs.N_FILTERED, centres,
                         s_queries)
    router = QueryRouter(device=dev)
    router.vector.ingest_matrix([f"k{i}" for i in range(args.rows)], corpus)
    report = {}
    lat, _, _ = cs.similar_series(router, [
        f"SIMILAR {cs.vec_literal(q)} TOP {cs.TOP_K}"
        for q in queries[:cs.N_SINGLE]])
    cs.latency_stats(report, "pooled_single", lat)
    report["pooled_batch_qps"], _, _, _ = cs.batch_series(
        lambda: router.vector.batch_search(
            queries[cs.N_SINGLE:cs.N_SINGLE + cs.N_BATCH], cs.TOP_K))
    del router
    report.update(cs.run_mesh(args, dev, corpus, queries, on_card, report))
    out = dict(report, rows=args.rows,
               total_s=time.perf_counter() - t_start,
               card=cs.smi_line() if on_card else None,
               host_cpu=cs.host_cpu())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "mesh_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
