#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s auto-IVF phases alone on one NVIDIA card: the
corpus of phase 3 (``--rows`` rows from ``--seed``, the same draws),
phases 4-6, phase 17 (the ``TOP 65`` batch on the non-fast batched
route with its steps timed, the top-1 batched route, an index through
add / delete / compact) and phase 12a (served auto-IVF). The phases
themselves are unchanged, gates included. This is how the non-fast
route is timed after a change to it without the rest of the script.

Usage, from the root of a checkout::

    python scripts/torch_ivf_phase.py [--seed 0] [--rows 4194304]

Writes chiprun_out/ivf_phase.json (phase 17's numbers, the launch counts
of each part, A's single p50 and batch QPS) and prints it as one JSON
line.
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

KEEP = ("top65", "top1_", "delta", "launches_", "phase17", "batch_qps",
        "single_p50", "recall_")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4_194_304)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ivf_phase: no CUDA device", file=sys.stderr)
        return 2
    from neumann_tpu_torch.ops import kernels as tk

    tk.build_kernels()
    os.makedirs("chiprun_out", exist_ok=True)
    # chip_smoke.run's draws: centres, A's rows and A's queries
    s_centres, s_corpus, s_queries = np.random.SeedSequence(
        args.seed).spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    t0 = time.perf_counter()
    report = cs.run_ivf(args, torch.device("cuda"), centres, s_corpus,
                        s_queries, None, True)
    out = {k: v for k, v in report.items() if k.startswith(KEEP)}
    out.update(wall_s=time.perf_counter() - t0, card=cs.smi_line())
    with open(os.path.join("chiprun_out", "ivf_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
