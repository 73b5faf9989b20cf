"""Time cells A, B and C of chip_smoke.py (the auto-IVF route, the f32
pooled route and the int8 collection) for two or more checkouts on one
card, each tree in a process of its own, in the order given.

    python scripts/torch_cells_ab.py --trees build/parent . . build/parent

Each process imports its tree's ``neumann_tpu_torch`` (its kernels built
from its ``csrc/``) and takes the data recipe and the series from this
checkout's ``chip_smoke.py`` (``mixture``, ``similar_series``,
``batch_series``, from ``--seed`` as there):

* A: 4,194,304 x 768 rows through ``ingest_matrix``; the first SIMILAR
  builds the auto-IVF index (``first_query_incl_build_s``), then 63
  singles (p50 / p99) and a batch of 1,024 (QPS over the median of the
  last 3 of 4 calls);
* B: 1,048,576 rows of phases 7-9's recipe through ``ingest_matrix``
  into the default corpus (the f32 pooled route and its rerank); 64
  singles and a batch of 1,024, whose call is then split
  (``b_batch_split``): 8 more calls, each its host ms and its span on
  the card between two CUDA events, and one under chip_smoke.py's
  ``profile_calls`` (the kernels' summed device ms, the top kernels;
  tables in ``chiprun_out/profile_b_batch_<i>_*.txt``, i the tree's
  place in ``--trees``);
* C: the same rows stored row by row in a ``QUANTIZATION int8``
  collection; 64 singles and a batch of 1,024.

Prints one JSON object and writes it to ``chiprun_out/cells_ab.json``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    port lazily, so they use the tree on the path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def b_batch_split(cs, fn, tag: str) -> dict:
    """B's batch call split into host and device time (module
    docstring)."""
    import torch

    host, span = [], []
    for _ in range(8):
        t0_ev = torch.cuda.Event(enable_timing=True)
        t1_ev = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t0_ev.record()
        fn()
        t1_ev.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        span.append(t0_ev.elapsed_time(t1_ev))
    name = f"b_batch_{tag}"
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof = cs.profile_calls({name: fn}, out_dir)[name]
    return {"b_batch_host_ms": host, "b_batch_span_ms": span,
            "b_batch_busy_ms": prof["device_busy_ms"],
            "b_batch_top_kernels_ms": prof["top_kernels_ms"]}


def run_tree(seed: int, tag: str) -> dict:
    import numpy as np
    import torch

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    cs = _chip_smoke()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tk.build_kernels()
    rec = {"tree": os.getcwd(), "build_kernels_s": time.perf_counter() - t0}
    root = np.random.SeedSequence(seed)
    s_centres, s_corpus, s_queries = root.spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (cs.N_CENTRES, cs.DIM)).astype(np.float32)

    # ---- A: the auto-IVF route --------------------------------------------
    rows = 4_194_304
    corpus = cs.mixture(rows, centres, s_corpus)
    queries = cs.mixture(cs.N_SINGLE + cs.N_BATCH + 1, centres, s_queries)
    router = QueryRouter(device=dev)
    router.vector.ingest_matrix([f"k{i}" for i in range(rows)], corpus,
                                copy=False)
    lat, _, _ = cs.similar_series(router, [
        f"SIMILAR {cs.vec_literal(q)} TOP {cs.TOP_K}"
        for q in queries[:cs.N_SINGLE]])
    rec["a_first_query_incl_build_s"] = lat[0] / 1e3
    rec["a_single_p50_ms"] = float(np.percentile(lat[1:], 50))
    rec["a_single_p99_ms"] = float(np.percentile(lat[1:], 99))
    batch = queries[cs.N_SINGLE:cs.N_SINGLE + cs.N_BATCH]
    rec["a_batch_qps"], rec["a_batch_s"], _, _ = cs.batch_series(
        lambda: router.vector.batch_search(batch, cs.TOP_K))
    del router, corpus
    gc.collect()
    torch.cuda.empty_cache()

    # ---- B: the f32 pooled route -----------------------------------------
    s_corpus7, s_queries7 = root.spawn(2)
    n = cs.POOLED_ROWS
    corpus = cs.mixture(n, centres, s_corpus7)
    queries = cs.mixture(cs.N_SINGLE + cs.N_BATCH + cs.N_FILTERED, centres,
                         s_queries7)
    batch = queries[cs.N_SINGLE:cs.N_SINGLE + cs.N_BATCH]
    router = QueryRouter(device=dev)
    router.vector.ingest_matrix([f"k{i}" for i in range(n)], corpus)
    lat, _, _ = cs.similar_series(router, [
        f"SIMILAR {cs.vec_literal(q)} TOP {cs.TOP_K}"
        for q in queries[:cs.N_SINGLE]])
    rec["b_single_p50_ms"] = float(np.percentile(lat[1:], 50))
    rec["b_single_p99_ms"] = float(np.percentile(lat[1:], 99))
    rec["b_batch_qps"], rec["b_batch_s"], _, _ = cs.batch_series(
        lambda: router.vector.batch_search(batch, cs.TOP_K))
    rec.update(b_batch_split(
        cs, lambda: router.vector.batch_search(batch, cs.TOP_K), tag))
    del router
    gc.collect()
    torch.cuda.empty_cache()

    # ---- C: an int8 collection --------------------------------------------
    router = QueryRouter(device=dev)
    eng = router.vector
    router.execute(f"CREATE COLLECTION q8 DIM {cs.DIM} QUANTIZATION int8")
    with eng.bulk_ingest():
        for i in range(n):
            eng.store_in_collection("q8", f"k{i}", corpus[i])
    lat, _, _ = cs.similar_series(router, [
        f"SIMILAR {cs.vec_literal(q)} IN q8 TOP {cs.TOP_K}"
        for q in queries[:cs.N_SINGLE]])
    rec["c_single_p50_ms"] = float(np.percentile(lat[1:], 50))
    rec["c_single_p99_ms"] = float(np.percentile(lat[1:], 99))
    rec["c_batch_qps"], rec["c_batch_s"], _, _ = cs.batch_series(
        lambda: eng.batch_search_ns(batch, cs.TOP_K, ns="col/q8"))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="0", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("AB " + json.dumps(run_tree(args.seed, args.tag)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--seed",
             str(args.seed), "--tag", str(i)], cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(f"tree {tree} failed ({proc.returncode})", flush=True)
            return 1
        runs.append(json.loads(lines[-1]))
        print(f"{tree}: " + json.dumps({k: v for k, v in runs[-1].items()
                                        if not k.endswith(("batch_s",
                                                           "kernels_ms"))}),
              flush=True)
    out = {"card": smi, "runs": runs}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "cells_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
