#!/usr/bin/env python3
"""Time cell A17's TOP 65 batch on one NVIDIA card with the non-fast
batched first pass of two trees in turns: this checkout's
``ops/ivf._score_windows`` and another checkout's (for example the parent
commit's), swapped into one router over one index.

Usage, from the root of a checkout::

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python scripts/torch_top65_ab.py --other build/parent [--seed 0]
        [--rows 4194304]

The other tree's ``neumann_tpu_torch/ops/ivf.py`` and ``ops/kernels.py``
are loaded by path under other module names: its ``_score_windows``
(and whatever of its own module it calls, with its own kernels built
from its own ``csrc/``) runs in place of this tree's, everything else of
the route is this tree's. The route's launches of a turn are the two
kernels modules' counts together. Builds ``chip_smoke.py``'s phase-3 corpus from
``--seed`` (the same draws) and its auto-IVF index (the first SIMILAR),
then runs turns other, this, this, other, each:

* the batch of 1,024 ``TOP 65`` queries (chip_smoke's phase 17b batch)
  through ``router.vector.batch_search``: four calls (QPS over the median
  of the last three, as chip_smoke), then ``--calls`` more, each its host
  ms, and one under ``chip_smoke.profile_calls`` (the kernels' summed
  device ms and the card's busy share; tables in
  ``chiprun_out/profile_top65_<i>_*.txt``, i the turn);
* the first pass (``batched_ivf_topk``) on the inputs the route gave it,
  as ``chip_smoke.top65_steps`` times it: CUDA events over 3 calls, the
  device time and launches of one call from torch.profiler.

The hits of every turn must be equal (both first passes select in
``lax.top_k``'s order on exact scores). Writes chiprun_out/top65_ab.json
and prints it as one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def load_by_path(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def other_score_windows(tree: str):
    """The other tree's ``_score_windows`` and its kernels module, both
    loaded by path: its ``ops/ivf.py`` calls its own ``ops/kernels.py``,
    which builds the other tree's ``csrc/`` into the other tree's
    ``build/``."""
    ops = os.path.join(tree, "neumann_tpu_torch", "ops")
    kern = load_by_path(os.path.join(ops, "kernels.py"),
                        "neumann_other_kernels")
    mod = load_by_path(os.path.join(ops, "ivf.py"), "neumann_other_ivf")
    mod.kernels = kern
    return mod._score_windows, kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout whose first pass is timed "
                         "beside this one's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--calls", type=int, default=12)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_top65_ab: no CUDA device", file=sys.stderr)
        return 2
    import neumann_tpu_torch  # noqa: F401  (sets TF32 off)
    from neumann_tpu_torch.ops import ivf as tivf
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    dev = torch.device("cuda")
    tk.build_kernels()
    out = dict(card=cs.smi_line(), host_cpu=cs.host_cpu(),
               other=args.other)
    other, other_tk = other_score_windows(args.other)
    other_tk.build_kernels()
    first_pass = {"this": tivf._score_windows, "other": other}
    s_centres, s_corpus, s_queries = np.random.SeedSequence(
        args.seed).spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)
    t0 = time.perf_counter()
    corpus = cs.mixture(args.rows, centres, s_corpus)
    queries = cs.mixture(cs.N_SINGLE + cs.N_BATCH + 1, centres, s_queries)
    router = QueryRouter(device=dev)
    router.vector.ingest_matrix([f"k{i}" for i in range(args.rows)], corpus,
                                copy=False)
    router.execute(f"SIMILAR {cs.vec_literal(queries[0])} TOP {cs.TOP_K}")
    out["setup_s"] = time.perf_counter() - t0
    eng = router.vector
    batch = queries[cs.N_SINGLE:cs.N_SINGLE + cs.N_BATCH]
    with cs.captured(tivf, "batched_ivf_topk") as calls:
        eng.batch_search(batch[:cs.N_BATCH], cs.TOP65)
    a, kw = calls[-1]
    if kw.get("fused") == "pallas":
        raise AssertionError("the TOP 65 batch took the fast route")

    def call():
        return eng.batch_search(batch, cs.TOP65)

    turns, hits = [], {}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for i, tag in enumerate(("other", "this", "this", "other")):
        tivf._score_windows = first_pass[tag]
        try:
            tk.reset_launch_counts()
            other_tk.reset_launch_counts()
            qps, times, rows, _ = cs.batch_series(call, cs.TOP65)
            launches = {n: c + other_tk.LAUNCHES.get(n, 0)
                        for n, c in tk.LAUNCHES.items()
                        if c + other_tk.LAUNCHES.get(n, 0)}
            host = []
            for _ in range(args.calls):
                t0 = time.perf_counter()
                call()
                host.append((time.perf_counter() - t0) * 1e3)
            prof = cs.profile_calls({f"top65_{i}": call},
                                    out_dir)[f"top65_{i}"]
            step = cs.torch_step(lambda: tivf.batched_ivf_topk(*a, **kw), 3,
                                 f"first pass ({tag})")
        finally:
            tivf._score_windows = first_pass["this"]
        hits.setdefault(tag, rows)
        turns.append(dict(tree=tag, qps=qps, batch_s=times,
                          launches=launches, host_ms=host,
                          host_ms_median=float(np.median(host)),
                          device_busy_ms=prof["device_busy_ms"],
                          device_busy_share=prof["device_busy_share"],
                          first_pass=step))
        cs.say(f"[top65_ab] {tag}: {qps:.0f} QPS; host median "
               f"{np.median(host):.1f} ms of {args.calls} calls; device "
               f"busy {cs.ms_text(prof['device_busy_ms'], 2)} ms; first "
               f"pass {step['ms']:.3f} ms (device "
               f"{cs.ms_text(step['device_ms'])}, {step['launches']} "
               f"launches); route launches {launches}")
    out["turns"] = turns
    out["hits_differ"] = sum(x != y for x, y in zip(hits["this"],
                                                     hits["other"]))
    for tag in ("this", "other"):
        mine = [t for t in turns if t["tree"] == tag]
        out[f"{tag}_qps"] = [t["qps"] for t in mine]
        out[f"{tag}_host_ms_median"] = [t["host_ms_median"] for t in mine]
        out[f"{tag}_device_busy_ms"] = [t["device_busy_ms"] for t in mine]
        out[f"{tag}_first_pass_ms"] = [t["first_pass"]["ms"] for t in mine]
        out[f"{tag}_first_pass_device_ms"] = [t["first_pass"]["device_ms"]
                                             for t in mine]
    with open(os.path.join(out_dir, "top65_ab.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    if out["hits_differ"]:
        raise AssertionError(f"hits differ between the trees' first "
                             f"passes in {out['hits_differ']} queries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
