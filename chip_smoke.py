#!/usr/bin/env python3
"""Drive the PyTorch port's auto-IVF SIMILAR path once on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit (nvcc)::

    python3 chip_smoke.py [--seed 0] [--rows 4194304]

Phases (each raises on failure; exit code 0 only if all pass):

1. print the card's name and power limit (nvidia-smi), build the two
   CUDA kernels from neumann_tpu_torch/csrc and print the build time;
2. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes (probe: 32 queries x 81 probes x 1,024-row
   windows x 768; batched top-2: 4,096 windows x 64 slots) and time
   both with CUDA events;
3. generate a 4,194,304 x 768 corpus from --seed with numpy (4,096
   N(0,1) centres + sigma 0.25 noise) and load it with
   ``router.vector.ingest_matrix``;
4. with every launch count at 0: 64 ``router.execute("SIMILAR [...]
   TOP 10")`` queries (the first builds the IVF index and is timed on
   its own; p50/p99 over the rest), then ``router.vector.batch_search``
   on 1,024 queries (QPS); read the launch counts;
5. recall@10 of both routes against the port's exact f32 scan over all
   rows (each >= 0.95), and both kernels launched by the main path;
6. re-embed one key, search with the new vector, that key comes first.

After the counted phase it also profiles 8 single SIMILARs and one
batch (cProfile on the host, torch.profiler on the device) into
chiprun_out/profile_*.txt, and the first SIMILAR (the build) into
chiprun_out/profile_build_host.txt.

Prints the metrics JSON line, the kernels JSON line, the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Everything is also
written to chiprun_out/chip_smoke.json. Fails (non-zero, no result)
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DIM = 768
N_CENTRES = 4096
SIGMA = 0.25
TOP_K = 10
N_SINGLE = 64
N_BATCH = 1024
MIN_RECALL = 0.95
# probe: f32 sums in another order; for unit rows the worst case is
# d * 2^-24 ~= 4.6e-5
PROBE_ATOL = 1e-4
KERNELS = {
    "ivf_probe": dict(source="neumann_tpu_torch/csrc/ivf_probe.cu",
                      replaces="neumann_tpu/ops/pallas_kernels.py:212"),
    "batched_probe": dict(source="neumann_tpu_torch/csrc/batched_probe.cu",
                          replaces="neumann_tpu/ops/pallas_kernels.py:329"),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host CPU's model and core count: single-query latency and
    batch QPS are host-bound, so they move with it."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model} x {os.cpu_count()}"


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(dev, rows: int, seed: int) -> dict:
    import torch

    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=dev).manual_seed(seed)
    window, nprobe, n_probe_q = 1024, 81, 32
    buf = torch.randint(-127, 128, (rows, DIM), generator=g, device=dev,
                        dtype=torch.int8)
    # realistic multipliers: 1/||row|| (unit rows), some dead rows
    rm = torch.cat([torch.rsqrt((buf[s:s + 65536].float() ** 2).sum(1))
                    for s in range(0, rows, 65536)])
    rm[::997] = 0.0
    out = {}

    sb = torch.randint(0, rows // 128 - window // 128 + 1,
                       (n_probe_q, nprobe), generator=g, device=dev,
                       dtype=torch.int32)
    qs = torch.randn(n_probe_q, DIM, generator=g, device=dev)
    qs /= qs.norm(dim=1, keepdim=True)
    got = tk.ivf_probe_scores(buf, rm, sb, qs, window)
    want = tk.ivf_probe_scores_plain(buf, rm, sb, qs, window)
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("ivf_probe: -inf slots differ from plain")
    live = torch.isfinite(want)
    err = float((got[live] - want[live]).abs().max())
    if not err <= PROBE_ATOL:
        raise AssertionError(f"ivf_probe: max |kernel - plain| {err} > "
                             f"{PROBE_ATOL}")
    out["ivf_probe"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.ivf_probe_scores(buf, rm, sb, qs, window), 20),
        plain_ms=cuda_ms(
            lambda: tk.ivf_probe_scores_plain(buf, rm, sb, qs, window), 2,
            warm=False),
        shape=f"Q={n_probe_q} nprobe={nprobe} window={window} d={DIM}")
    say(f"[2] ivf_probe kernel vs plain: max_abs_err {err:.3g} "
        f"(atol {PROBE_ATOL}); kernel {out['ivf_probe']['ms']:.4f} ms, "
        f"plain {out['ivf_probe']['plain_ms']:.4f} ms")
    del got, want, live, sb, qs

    n_win, q_cap = rows // window, 64
    qsel = torch.randint(-127, 128, (n_win, q_cap, DIM), generator=g,
                         device=dev, dtype=torch.int8)
    # ~1/3 of the slots filled, in order (as the query tables fill them)
    filled = torch.randint(0, 2 * q_cap // 3, (n_win, 1), generator=g,
                           device=dev)
    scm = (torch.rand(n_win, q_cap, generator=g, device=dev) * 0.004
           + 0.004) * (torch.arange(q_cap, device=dev) < filled)
    rm2 = rm[:n_win * window].reshape(n_win, window)
    b = buf[:n_win * window]
    got = tk.batched_probe(b, rm2, qsel, scm, window, top2=True)
    want = tk.batched_probe_plain(b, rm2, qsel, scm, window, top2=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"batched_probe: {bad} packed words differ "
                             f"from plain (must be bit-exact)")
    s_got, _ = tk.decode_strided_pool_bits(got, window)
    s_want, _ = tk.decode_strided_pool_bits(want, window)
    fin = torch.isfinite(s_want)
    err = float((s_got[fin] - s_want[fin]).abs().max()) if fin.any() else 0.0
    out["batched_probe"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: tk.batched_probe(b, rm2, qsel, scm, window,
                                            top2=True), 10),
        plain_ms=cuda_ms(lambda: tk.batched_probe_plain(
            b, rm2, qsel, scm, window, top2=True), 1, warm=False),
        shape=f"C={n_win} q_cap={q_cap} window={window} d={DIM} top2")
    say(f"[2] batched_probe kernel vs plain: bit-exact, max_abs_err "
        f"{err:.3g}; kernel {out['batched_probe']['ms']:.4f} ms, plain "
        f"{out['batched_probe']['plain_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3: the corpus
# ---------------------------------------------------------------------------

def mixture(n: int, centres: np.ndarray, seed_seq, chunk: int = 1 << 17
            ) -> np.ndarray:
    """n rows of centre + SIGMA * N(0, 1), generated in parallel chunks
    (one independent stream per chunk, so the result does not depend on
    the thread schedule)."""
    out = np.empty((n, centres.shape[1]), np.float32)
    starts = list(range(0, n, chunk))
    seqs = seed_seq.spawn(len(starts))

    def fill(i):
        s = starts[i]
        e = min(n, s + chunk)
        rng = np.random.default_rng(seqs[i])
        which = rng.integers(0, len(centres), e - s)
        rng.standard_normal(out=out[s:e], dtype=np.float32)
        out[s:e] *= SIGMA
        out[s:e] += centres[which]

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(fill, range(len(starts))))
    return out


def profile_paths(router, stmts, fresh, batch, out_dir: str) -> dict:
    """Where the time goes, after the counted phase (its launches are not
    counted). Host: cProfile of 8 single SIMILARs and of one batch (top
    functions by cumulative time). Device: torch.profiler over the same
    calls; kernel time summed from the CUDA events, and the device busy
    share = kernel time / wall time (the profiler's own overhead is in
    the wall time). Parse: host time of ``parse_cached`` on statements
    it has not seen (``fresh``), the router's first step."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from neumann_tpu_torch.lang.parser import parse_cached

    parse_ms = []
    for stmt in fresh:
        t0 = time.perf_counter()
        parse_cached(stmt)
        parse_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"parse_ms": parse_ms}
    say(f"[profile] parse of an unseen 768-float SIMILAR: median "
        f"{float(np.median(parse_ms)):.3f} ms")
    calls = {"single": lambda: [router.execute(s) for s in stmts],
             "batch": lambda: router.vector.batch_search(batch, TOP_K)}
    for name, fn in calls.items():
        prof = cProfile.Profile()
        prof.enable()
        fn()
        prof.disable()
        txt = io.StringIO()
        pstats.Stats(prof, stream=txt).sort_stats("cumulative").print_stats(30)
        with open(os.path.join(out_dir, f"profile_{name}_host.txt"), "w") as f:
            f.write(txt.getvalue())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {}
        for e in tp.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.name] = kernels.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        busy_ms = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        out[name] = dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                         device_busy_share=busy_ms / (wall * 1e3),
                         top_kernels_ms=top)
        with open(os.path.join(out_dir, f"profile_{name}_device.txt"),
                  "w") as f:
            f.write(tp.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=25))
        say(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / (wall * 1e3):.1f}%); "
            f"top: {[(k[:48], round(v, 3)) for k, v in top[:5]]}")
    return out


def vec_literal(v: np.ndarray) -> str:
    return "[" + ", ".join(f"{x:.7g}" for x in v.tolist()) + "]"


def recall(got_rows, truth: np.ndarray) -> float:
    return float(np.mean([len(set(g) & set(t.tolist())) / truth.shape[1]
                          for g, t in zip(got_rows, truth)]))


def run(args, dev, config=None, on_card: bool = True) -> dict:
    """All phases on ``dev``. ``config`` (a VectorEngineConfig) and
    on_card=False exist only to rehearse the control flow on the CPU at
    a toy size: phases 1-2 and the launch check need the card."""
    import torch

    import neumann_tpu_torch  # noqa: F401  (sets TF32 off)
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.scan import topk_scan
    from neumann_tpu_torch.router import QueryRouter

    report = {}
    if on_card:
        os.makedirs("chiprun_out", exist_ok=True)
        report["smi"] = smi_line()
        report["host_cpu"] = host_cpu()
        say(f"[1] {report['smi']}; host {report['host_cpu']}")
        t0 = time.perf_counter()
        tk.build_kernels(verbose=True)
        report["build_kernels_s"] = time.perf_counter() - t0
        say(f"[1] kernels built in {report['build_kernels_s']:.3f} s")
        report["kernels"] = check_kernels(dev, args.rows, args.seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    root = np.random.SeedSequence(args.seed)
    s_centres, s_corpus, s_queries = root.spawn(3)
    centres = np.random.default_rng(s_centres).standard_normal(
        (N_CENTRES, DIM)).astype(np.float32)
    t0 = time.perf_counter()
    corpus = mixture(args.rows, centres, s_corpus)
    queries = mixture(N_SINGLE + N_BATCH + 1, centres, s_queries)
    report["generate_s"] = time.perf_counter() - t0
    router = QueryRouter(device=dev)
    if config is not None:
        router.vector.config = config
    t0 = time.perf_counter()
    keys = [f"k{i}" for i in range(args.rows)]
    router.vector.ingest_matrix(keys, corpus, copy=False)
    report["ingest_s"] = time.perf_counter() - t0
    say(f"[3] corpus {args.rows} x {DIM} generated in "
        f"{report['generate_s']:.1f} s, ingested in "
        f"{report['ingest_s']:.1f} s")

    # ---- phase 4: the main path, counted -----------------------------
    gc_pauses = []
    gc_t0 = [0.0]

    def gc_watch(phase, info):
        if info.get("generation") == 2:
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                gc_pauses.append((time.perf_counter() - gc_t0[0]) * 1e3)

    gc.callbacks.append(gc_watch)
    tk.reset_launch_counts()
    single_rows, lat = [], []
    for i in range(N_SINGLE):
        stmt = f"SIMILAR {vec_literal(queries[i])} TOP {TOP_K}"
        build_prof = None
        if i == 0 and on_card:
            import cProfile

            build_prof = cProfile.Profile()
            build_prof.enable()
        t0 = time.perf_counter()
        res = router.execute(stmt)
        lat.append(time.perf_counter() - t0)
        if build_prof is not None:
            import io
            import pstats

            build_prof.disable()
            txt = io.StringIO()
            pstats.Stats(build_prof, stream=txt).sort_stats(
                "cumulative").print_stats(40)
            with open(os.path.join("chiprun_out", "profile_build_host.txt"),
                      "w") as f:
                f.write(txt.getvalue())
        scores = [h["score"] for h in res.results]
        if res.kind != "similar" or len(scores) != TOP_K or not all(
                np.isfinite(scores)) or max(abs(x) for x in scores) > 1.01:
            raise AssertionError(f"bad SIMILAR result: {res.results}")
        single_rows.append([int(h["key"][1:]) for h in res.results])
    report["first_query_incl_build_s"] = lat[0]
    report["single_ms"] = [x * 1e3 for x in lat[1:]]
    warm = np.array(lat[1:]) * 1e3
    report["single_p50_ms"] = float(np.percentile(warm, 50))
    report["single_p99_ms"] = float(np.percentile(warm, 99))
    batch = queries[N_SINGLE:N_SINGLE + N_BATCH]
    times = []
    for _ in range(4):                          # the first one warms up
        t0 = time.perf_counter()
        res_b = router.vector.batch_search(batch, TOP_K)
        times.append(time.perf_counter() - t0)
    report["batch_s"] = times
    times = times[1:]
    report["batch_qps"] = N_BATCH / float(np.median(times))
    launches = dict(tk.LAUNCHES)
    gc.callbacks.remove(gc_watch)
    report["gc_gen2_pauses_ms"] = gc_pauses
    say(f"[4] first SIMILAR (incl. index build) "
        f"{report['first_query_incl_build_s']:.2f} s; single p50 "
        f"{report['single_p50_ms']:.3f} ms p99 "
        f"{report['single_p99_ms']:.3f} ms; batch of {N_BATCH}: "
        f"{report['batch_qps']:.0f} QPS; launches {launches}")

    if on_card:
        report["profile"] = profile_paths(
            router, [f"SIMILAR {vec_literal(q)} TOP {TOP_K}"
                     for q in queries[:8]],
            [f"SIMILAR {vec_literal(q)} TOP {TOP_K}" for q in batch[:8]],
            batch, "chiprun_out")

    # ---- phase 5: recall against the exact scan, launches --------------
    slab = router.vector._corpora[DIM].slab
    emb, valid = slab.device_view()
    qd = torch.from_numpy(queries[:N_SINGLE + N_BATCH]).to(dev)
    _, oracle = topk_scan(emb, qd, TOP_K, "cosine", valid)
    oracle = oracle.cpu().numpy()
    batch_rows = []
    for hits in res_b:
        if len(hits) != TOP_K or not all(np.isfinite(h.score) for h in hits):
            raise AssertionError(f"bad batch_search result: {hits}")
        batch_rows.append([int(h.key[1:]) for h in hits])
    report["recall_single"] = recall(single_rows, oracle[:N_SINGLE])
    report["recall_batch"] = recall(batch_rows, oracle[N_SINGLE:])
    say(f"[5] recall@{TOP_K}: single {report['recall_single']:.4f}, "
        f"batch {report['recall_batch']:.4f} (>= {MIN_RECALL})")
    if min(report["recall_single"], report["recall_batch"]) < MIN_RECALL:
        raise AssertionError("recall below the limit")
    if on_card and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    # ---- phase 6: delta rescan -----------------------------------------
    key = f"k{args.rows // 3}"
    new = queries[-1]
    router.execute(f"EMBED STORE '{key}' {vec_literal(new)}")
    hits = router.execute(f"SIMILAR {vec_literal(new)} TOP {TOP_K}").results
    if hits[0]["key"] != key or hits[0]["score"] < 0.9999:
        raise AssertionError(f"re-embedded {key} not first: {hits[:3]}")
    say(f"[6] delta rescan: re-embedded {key} comes first "
        f"(score {hits[0]['score']:.6f})")

    report["launches"] = launches
    if on_card:
        report["peak_device_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4_194_304)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import neumann_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    if args.rows % 1024 or args.rows < 4_000_000:
        print("chip_smoke: --rows must be a multiple of 1,024 and at least "
              "the auto-IVF threshold (4,000,000)", file=sys.stderr)
        return 2

    report = run(args, torch.device("cuda"))
    kernels = {"kernels": [
        dict(name=name, route="cuda", source=meta["source"],
             replaces=meta["replaces"],
             launches=int(report["launches"][name]),
             max_abs_err=report["kernels"][name]["max_abs_err"],
             ms=report["kernels"][name]["ms"],
             plain_ms=report["kernels"][name]["plain_ms"])
        for name, meta in KERNELS.items()]}
    metrics = {k: report[k] for k in (
        "single_p50_ms", "single_p99_ms", "batch_qps",
        "first_query_incl_build_s", "recall_single", "recall_batch",
        "build_kernels_s", "generate_s", "ingest_s", "peak_device_mem_gb")}
    metrics["parse_ms_median"] = float(np.median(
        report["profile"]["parse_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(report, **kernels), f, indent=1, default=str)
    print(json.dumps({"metrics": metrics, "card": report["smi"],
                      "host_cpu": report["host_cpu"]}))
    print(json.dumps(kernels))
    print(report["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
