#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16 alone on one NVIDIA card, with a
store of ``--rows`` rows: the rows phases 7-9 generate from ``--seed``
(the same draws), the first ``--rows`` of them in the default namespace
and the first ``chip_smoke.ROLLBACK_SUB_ROWS`` in the int8 and binary
collections. Phase 16 itself is unchanged (checkpoint, re-embed, a
DELETE with its automatic checkpoint, ROLLBACK, every route's hits
held, rows 5-7 launched, EXPLAIN, the query cache, the blob and the LLM
cache). This is how the phase was measured on the uncut store (1,048,576
rows, the default), where it ran past its time in ``chip_smoke.py``.

Usage, from the root of a checkout::

    python scripts/torch_extended_phase.py [--seed 0] [--rows 1048576]

Writes chiprun_out/extended_phase.json and prints it as one JSON line.
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_extended_phase: no CUDA device", file=sys.stderr)
        return 2
    from neumann_tpu_torch.ops import kernels as tk

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
    cs.ROLLBACK_ROWS = args.rows
    t0 = time.perf_counter()
    report = cs.run_extended(args, torch.device("cuda"), corpus, queries,
                             on_card=True)
    out = dict(report, rows=args.rows, extended_s=time.perf_counter() - t0,
               card=cs.smi_line(), host_cpu=cs.host_cpu())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "extended_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
