"""Row 6's TF32 kernel (``csrc/f32_pooled.cu``, ``tf32_kernel``) on one
card at B's batch (Q 1,024 x 1,048,576 x 768, pool 512): parts of its
time, from variants of the source built with a part changed or taken
out, each timed alone (CUDA events over repeated launches of the kernel
entry, the query parts made once), in turns with the source.

* ``one_pass``: the big x big products alone (4 wgmma a stage, not 12):
  what the two small passes cost.
* ``no_epilogue``: no pack, no pool maxima (the sums still formed).
* ``no_small_load``: the small query part not loaded (its products read
  whatever the slot holds): what the third TMA load of a stage costs.
* ``stages3``: a ring of 3 stages, not 4.
* ``no_mask``: the TF32 parts as ``cvt.rna.tf32.f32`` leaves them,
  without clearing their low 13 bits again (reported bit-equal or not).

The variants' outputs are wrong by design except ``stages3``, which is
held bit-equal to the source's. Run on a
card from the repository's root (about 1 min):
``python scripts/torch_f32_pooled_probe.py``; the record goes to
``chiprun_out/f32_pooled_probe.json``.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neumann_tpu_torch.ops import kernels as tk  # noqa: E402

Q, ROWS, DIM, POOL = 1024, 1 << 20, 768, 512
LOAD_SMALL = ("    tma_load_2d(stage + kWRowBytes + G::kPartBytes, &part_map, "
              "k0,\n                qp + bp.q0, &full[st]);\n")
VARIANTS = {
    "source": [],
    "one_pass": [
        ("wgmma_tf32<kNQ>(acc, fs[j], db + 2 * j, j);", "{}"),
        ("wgmma_tf32<kNQ>(acc, fb[j], ds + 2 * j, 1);", "{}"),
        ("wgmma_tf32<kNQ>(acc, fb[j], db + 2 * j, 1);",
         "wgmma_tf32<kNQ>(acc, fb[j], db + 2 * j, j);")],
    "no_epilogue": [("__fadd_rn(sum[i], acc[i]);\n    }\n"
                     "    if (kt != k_steps - 1) return;",
                     "__fadd_rn(sum[i], acc[i]);\n    }\n"
                     "    if (kt != k_steps - 1 || n_q > 0) return;")],
    "no_small_load": [
        (LOAD_SMALL, ""),
        ("mbar_arrive_expect_tx(&full[st], G::kStageBytes);",
         "mbar_arrive_expect_tx(&full[st], G::kStageBytes - G::kPartBytes);")],
    "stages3": [("constexpr int kWStages = 4;", "constexpr int kWStages = 3;")],
    "no_mask": [("  big = b & 0xFFFFE000u;", "  big = b;"),
                ("  small = s & 0xFFFFE000u;", "  small = s;")],
}
EXACT = ("source", "stages3")


def build_variants(out_dir: Path) -> dict:
    """Each variant's source built alone into a shared library."""
    src = (tk.CSRC_DIR / "f32_pooled.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [tk._nvcc(), *tk.NVCC_FLAGS, "-shared", "-I", str(tk.CSRC_DIR),
             "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.neumann_f32_pooled_bits.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i64, i32, i32, i32, vp]
        lib.neumann_f32_pooled_bits.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs = build_variants(ROOT / "build" / "f32_pooled_probe")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(ROWS, DIM, generator=g, device=dev)
    qs = x[torch.randint(0, ROWS, (Q,), generator=g, device=dev)] \
        + 0.1 * torch.randn(Q, DIM, generator=g, device=dev)
    rm, qm = 1.0 / x.norm(dim=1), 1.0 / qs.norm(dim=1)
    bias = torch.full((ROWS,), 2.0, device=dev)
    parts = tk._f32_parts(qs)
    outs = {name: torch.empty((Q, ROWS // POOL), dtype=torch.int32,
                              device=dev) for name in libs}

    def launch(name):
        err = libs[name].neumann_f32_pooled_bits(
            parts.data_ptr(), x.data_ptr(), qm.data_ptr(), rm.data_ptr(),
            bias.data_ptr(), outs[name].data_ptr(), Q, ROWS, DIM,
            parts.shape[2], POOL, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {name}: CUDA error {err}")

    def time_ms(name, reps=5):
        launch(name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch(name)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rec = {"card": smi, "shape": f"Q={Q} N={ROWS} d={DIM} pool={POOL}"}
    order = list(VARIANTS) + ["source"]
    times = {name: [] for name in VARIANTS}
    for name in order:
        times[name].append(time_ms(name))
    rec["ms"] = {name: sum(v) / len(v) for name, v in times.items()}
    rec["source_ms_runs"] = times["source"]
    rec["bit_equal_to_source"] = {
        name: bool(torch.equal(outs[name], outs["source"]))
        for name in EXACT + ("no_mask",)}
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "f32_pooled_probe.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0 if all(rec["bit_equal_to_source"][n] for n in EXACT) else 1


if __name__ == "__main__":
    sys.exit(main())
