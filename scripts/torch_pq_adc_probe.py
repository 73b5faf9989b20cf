"""Split the ADC scan's launch (row 8, ``csrc/pq_adc.cu``) on a card by
building variants of its source with parts switched off, and by launching
it with other plans, on the same inputs.

    python scripts/torch_pq_adc_probe.py

Variants (each a patched copy of the source under ``build/probe/``, built
with nvcc into a library of its own, all at once): ``full`` as committed;
``copies1``, the shared layout's tables unreplicated ([m][code][8]: the
four row slots of a quarter warp then collide on banks when their codes
agree mod 4); ``no_lookups``, the shared layout reads its codes but looks
up nothing (the staging, the selection and the barriers); ``no_stage``,
nothing loaded into the ring (the lookups on stale shared memory, the
selection, the barriers); ``stages4`` and ``stages5``, the select mode's
ring of 4 and 5 stages (3 committed); ``t384``, blocks of 384 threads (170
registers a thread against 128, passes of 3,072 rows). ``copies1``,
``no_lookups`` and ``no_stage`` give wrong results and are timed only;
the others are held equal to the plain version first.

Each variant runs the select mode (k 10) on 1,048,576 rows x M 96 (random
codes, 1 % dead rows) at Q 1,024 and 8 in the shared layout; ``full``
also at Q 1, 2, 3, 4 and 8 in both layouts (the switch between them), at
k 64, in scores mode, with the Q 1,024 launch under other counts of parts,
and split by kernel (transpose, interleave, the scan) from torch.profiler.
Times are CUDA events over back-to-back launches (the wrapper: launches,
the final torch.topk, the decode). Prints one JSON object and writes it to
``chiprun_out/pq_adc_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PATCHES = {
    "copies1": [("constexpr int kCopies = 4;", "constexpr int kCopies = 1;")],
    "no_lookups": [("        const float4 v =\n            *reinterpret_cast"
                    "<const float4*>(tm + code * kRowWords);",
                    "        const float4 v = make_float4(__uint_as_float("
                    "code), 0.f, 0.f, 0.f);")],
    "no_stage": [("          *reinterpret_cast<float4*>(td + ((c + unit / 2)"
                  " % kCopies) * kQb) =\n              r.v[j];", ""),
                 ("      copy_codes(b, mm, p);\n", "")],
    "stages4": [("constexpr int kSelectStages = 3;",
                 "constexpr int kSelectStages = 4;")],
    "stages5": [("constexpr int kSelectStages = 3;",
                 "constexpr int kSelectStages = 5;")],
    # 12 warps: 170 registers a thread, passes of 3,072 rows
    "t384": [("constexpr int kSharedThreads = 512;",
              "constexpr int kSharedThreads = 384;")],
}
# variants that compute the function (the others are timed only), and
# the rows of a shared-layout pass where a variant changes it
EXACT = ("full", "stages4", "stages5", "t384")
PASS_ROWS = {"t384": 3072}
VARIANTS = ("full", *PATCHES)
TOP_K = 10
N, M = 1 << 20, 96


def build_all() -> dict:
    """Every variant's library, compiled in parallel."""
    from neumann_tpu_torch.ops import kernels as tk

    src = (tk.CSRC_DIR / "pq_adc.cu").read_text()
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        text = src
        for old, new in PATCHES.get(name, ()):
            if old not in text:
                raise RuntimeError(f"patch {name} does not apply: {old[:40]}")
            text = text.replace(old, new)
        cu = out / f"pq_adc_{name}.cu"
        cu.write_text(text)
        so = out / f"libpq_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [tk._nvcc(), *tk.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, report = {}, {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: {log[-3000:]}")
        report[name] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        lib.neumann_pq_adc_scores.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32, i32,
            i64, i64, vp]
        lib.neumann_pq_adc_select.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
            i32, i32, i64, i64, vp]
        lib.neumann_pq_adc_scores.restype = i32
        lib.neumann_pq_adc_select.restype = i32
        libs[name] = lib
    return libs, report


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from neumann_tpu_torch.ops import kernels as tk

    smi = cs.smi_line()
    libs, ptxas = build_all()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(11)
    codes = torch.randint(0, 256, (N, M), generator=g, device=dev,
                          dtype=torch.uint8)
    valid = torch.rand(N, generator=g, device=dev) > 0.01
    tables = torch.rand(1024, M, 256, generator=g, device=dev) * 4.0
    plan_fn = tk._pq_adc_plan

    def forced(shared=None, parts=None):
        """The plan with the layout or the count of parts forced."""
        def plan(cols, q, m, k, gathered, select, n_sms):
            if shared is not None:
                saved = tk._PQ_SHARED_MIN_Q
                tk._PQ_SHARED_MIN_Q = 1 if shared else 1 << 20
                try:
                    p = plan_fn(cols, q, m, k, gathered, select, n_sms)
                finally:
                    tk._PQ_SHARED_MIN_Q = saved
            else:
                p = plan_fn(cols, q, m, k, gathered, select, n_sms)
            if parts is not None and p[0]:
                passes = -(-cols // tk._PQ_SHARED_PASS)
                span = -(-passes // parts) * tk._PQ_SHARED_PASS
                p = (p[0], p[1], -(-cols // span), span)
            return p
        return plan

    pass_rows = tk._PQ_SHARED_PASS

    def use(name, shared=None, parts=None):
        tk._lib = libs[name]
        tk._pq_adc_plan = forced(shared, parts)
        tk._PQ_SHARED_PASS = PASS_ROWS.get(name, pass_rows)

    def restore():
        tk._pq_adc_plan = plan_fn
        tk._PQ_SHARED_PASS = pass_rows

    def timed(name, q, k=TOP_K, shared=None, parts=None, select=True):
        use(name, shared, parts)
        t = tables[:q].contiguous()
        fn = ((lambda: tk.pq_adc_topk(codes, t, valid, k)) if select
              else (lambda: tk.pq_adc_scores(codes, t, valid)))
        try:
            return cs.cuda_ms(fn, 3 if q >= 256 else 20)
        finally:
            restore()

    out = {"card": smi, "shape": f"N {N} x M {M}, k {TOP_K}", "ptxas": ptxas}
    # the variants that compute the function are exact before timing
    for q in (1024, 8, 1):
        t = tables[:q].contiguous()
        want = tk.pq_adc_topk_plain(codes, t, valid, TOP_K)
        for name in EXACT:
            use(name)
            got = tk.pq_adc_topk(codes, t, valid, TOP_K)
            restore()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from plain at Q {q}")
    for name in VARIANTS:
        out[name] = {f"q{q}": timed(name, q, shared=True)
                     for q in (1024, 8)}
        print(name, json.dumps(out[name]), flush=True)
    full = out["full"]
    for q in (1, 2, 3, 4, 8, 16):
        full[f"shared_q{q}"] = timed("full", q, shared=True)
        full[f"lane_q{q}"] = timed("full", q, shared=False)
    full["k64_q1024"] = timed("full", 1024, k=64)
    full["k64_q1"] = timed("full", 1, k=64)
    full["scores_q1024"] = timed("full", 1024, select=False)
    for parts in (2, 4, 8, 16, 32, 64, 128):
        full[f"parts{parts}_q1024"] = timed("full", 1024, parts=parts)
    full["plan_q1024"] = plan_fn(N, 1024, M, TOP_K, False, True, sms)
    # where a launch's device time goes, by kernel
    tk._lib = libs["full"]
    for q in (1024, 8):
        t = tables[:q].contiguous()
        tk.pq_adc_topk(codes, t, valid, TOP_K)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as tp:
            for _ in range(3):
                tk.pq_adc_topk(codes, t, valid, TOP_K)
            torch.cuda.synchronize()
        split = {}
        for e in tp.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((n for n in ("pq_adc_kernel", "transpose_codes",
                                        "interleave_tables", "fill_empty")
                            if n in e.name), "other")
                split[key] = split.get(key, 0.0) + \
                    e.time_range.elapsed_us() / 3e3
        full[f"device_split_ms_q{q}"] = split
    print("full", json.dumps(full), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "pq_adc_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
