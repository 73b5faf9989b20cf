#!/usr/bin/env python3
"""Time ROLLBACK of ``chip_smoke.py`` phase 16's store both ways on one
NVIDIA card, in turns on the same store: as the router runs it (the
store's put hooks write the slab one row a call) and with the reload
inside ``VectorEngine.bulk_ingest`` (the rows queued, one vectorized
slab write a corpus). Order: bulk, per row, per row, bulk. After each
rollback the first SIMILAR of every route is timed (it rebuilds that
route's device view) and every route's hits must equal those taken
before the checkpoint (keys in order, scores within
``chip_smoke.ROLLBACK_ATOL``). The store holds ``--rows`` rows in the
default namespace (1,048,576 by default: phase 16's store before its
cut) and the first ``ROLLBACK_SUB_ROWS`` in each collection.

Usage, from the root of a checkout::

    python scripts/torch_rollback_ab.py [--seed 0] [--rows 1048576]

Writes chiprun_out/rollback_ab.json and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
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
        print("torch_rollback_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    root = np.random.SeedSequence(args.seed)
    s_centres, s_corpus, s_queries = root.spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    corpus = cs.mixture(args.rows, centres, s_corpus)
    queries = cs.mixture(cs.N_ROLLBACK_SINGLE + cs.N_ROLLBACK_FILTERED,
                         centres, s_queries)
    cs.ROLLBACK_ROWS = args.rows
    t0 = time.perf_counter()
    router, stmts = cs.rollback_router(dev, corpus, queries)
    out = {"card": cs.smi_line(), "host_cpu": cs.host_cpu(),
           "rows": args.rows, "load_s": time.perf_counter() - t0,
           "turns": []}
    before, _ = cs.rollback_hits(router, stmts)
    ck_dir = tempfile.mkdtemp(prefix="neumann_ckpt_")
    try:
        router.init_checkpoints(ck_dir)
        router.execute("CHECKPOINT 'pre'")
        ck = router.checkpoints
        for way in ("bulk", "per_row", "per_row", "bulk"):
            # a write, so that each rollback has something to undo
            router.execute(f"EMBED STORE 'k0' {cs.vec_literal(-corpus[0])}")
            t0 = time.perf_counter()
            if way == "bulk":
                with router.vector.restoring(), \
                        router.vector.bulk_ingest():
                    ck.rollback("pre")
            else:
                router.execute("ROLLBACK TO 'pre'")
            rollback_s = time.perf_counter() - t0
            after, lat = cs.rollback_hits(router, stmts)
            bad = {r: cs.same_route_hits(before[r], after[r],
                                         cs.ROLLBACK_ATOL) for r in stmts}
            # the rollback's own automatic checkpoint, not needed again
            ck.delete(ck.list()[0]["id"])
            turn = {"way": way, "rollback_s": rollback_s,
                    "first_query_ms": {r: v[0] for r, v in lat.items()},
                    "mismatches": bad}
            out["turns"].append(turn)
            cs.say(f"[rollback_ab] {turn}")
            if any(bad.values()):
                raise AssertionError(f"hits differ after {way}: {bad}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rollback_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
