#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 18 alone on one NVIDIA card: 18a on a
router of its own holding ``--rows`` of the rows phases 7-9 generate
from ``--seed`` (the same draws, ``{"cat": i % 16}``, in the default
namespace only: phase 7's router also holds the int8 and binary
collections, so ``init_chain`` seeds its state root from three times
the keys there), then 18b-18d unchanged (the consensus classification,
three replicas in this process, three node processes with the leader
killed). ``--device cpu`` rehearses the control flow without the card
(no launch checks, no device times).

Usage, from the root of a checkout::

    python scripts/torch_chain_phase.py [--seed 0] [--rows 1048576]
        [--cluster-rows 4096] [--device cuda]

Writes chiprun_out/chain_phase.json and prints it as one JSON line.
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
    ap.add_argument("--cluster-rows", type=int, default=cs.CLUSTER_ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_chain_phase: no CUDA device", file=sys.stderr)
        return 2
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    dev = torch.device(args.device)
    if on_card:
        tk.build_kernels()
    cs.CLUSTER_ROWS = args.cluster_rows
    # chip_smoke.run's draws: centres from the first spawn, phases 7-9's
    # rows from the second, phase 18b-d's from the last
    root = np.random.SeedSequence(args.seed)
    s_centres, _, _ = root.spawn(3)
    s_corpus, _ = root.spawn(2)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    corpus = cs.mixture(args.rows, centres, s_corpus)
    t0 = time.perf_counter()
    router = QueryRouter(device=dev)
    with router.vector.bulk_ingest():
        for i in range(args.rows):
            router.vector.store_embedding(f"k{i}", corpus[i],
                                          {"cat": i % cs.N_CATS})
    report = {"load_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    report.update(cs.run_chain(args, router, corpus, on_card))
    report["phase18a_s"] = time.perf_counter() - t0
    del router
    report.update(cs.run_chain_cluster(args, dev, centres,
                                       *root.spawn(2), on_card))
    out = dict(report, rows=args.rows, cluster_rows=args.cluster_rows,
               card=cs.smi_line() if on_card else None,
               host_cpu=cs.host_cpu())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chain_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
