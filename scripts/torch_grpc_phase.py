#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s serving phases alone on one NVIDIA card: the
auto-IVF router of phases 3-6 with phases 17, 12a and 19a (served over
HTTP, then over gRPC), then the brute-force router of phases 7-9 with
phases 12b, 19b and 20, then phase 14 (the pq and tt collections, with
row 8's repeated single-query check). The phases themselves are
unchanged, gates included; ``--pooled-rows`` may cut phases 7-9 below
``chip_smoke.py``'s 1,048,576 rows (with ``--no-pq``: phase 14's gate on
its batch's memory holds from that size). This is how the gRPC server's
phase is iterated without the rest of the script.

Usage, from the root of a checkout::

    python scripts/torch_grpc_phase.py [--seed 0] [--rows 4194304]
        [--pooled-rows 1048576] [--no-ivf] [--no-pq]

Writes chiprun_out/grpc_phase.json (phases 12 and 19's numbers, the
launch counts of each part, the repeated check's counts) and prints it
as one JSON line.
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

KEEP = ("served_", "grpc_", "points_", "launches_served", "phase19",
        "warmup", "pq_repeat", "pq_tables", "pq_hits", "pq_mismatches",
        "batch_qps", "single_p50")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--pooled-rows", type=int, default=cs.POOLED_ROWS)
    ap.add_argument("--no-ivf", action="store_true",
                    help="skip the auto-IVF router (phases 3-6, 17, 12a, "
                         "19a)")
    ap.add_argument("--no-pq", action="store_true", help="skip phase 14")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grpc_phase: no CUDA device", file=sys.stderr)
        return 2
    from neumann_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    tk.build_kernels()
    os.makedirs("chiprun_out", exist_ok=True)
    t_start = time.perf_counter()
    # chip_smoke.run's draws, in its order
    root = np.random.SeedSequence(args.seed)
    s_centres, s_corpus, s_queries = root.spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    report = {}
    if not args.no_ivf:
        report.update(cs.run_ivf(args, dev, centres, s_corpus, s_queries,
                                 None, True))
        torch.cuda.empty_cache()
    shared = {}
    report.update(cs.run_brute(args, dev, centres, *root.spawn(2), True,
                               shared))
    shared.pop("router")    # phases 7-9's router, kept for phase 21
    torch.cuda.empty_cache()
    if not args.no_pq:
        rec = {"library": cs.ADC_LIBRARY}
        sel = {"library": cs.ADC_SELECT_LIBRARY}
        report.update(cs.run_quantized(args, dev, shared["corpus"],
                                       shared["queries"], True, (rec, sel)))
    out = {k: v for k, v in report.items() if k.startswith(KEEP)}
    out.update(wall_s=time.perf_counter() - t_start, card=cs.smi_line())
    with open(os.path.join("chiprun_out", "grpc_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
