"""Row 9 (``csrc/int8_exact.cu``) on one card at A17's delta shapes
(419,430 rows x 768, 1 % dead): its error and parts of its time.

* The error of its scores and of the plain version's (f32
  ``torch.matmul``, TF32 off) against a float64 product, at Q 1, 16, 17
  and 1,024.
* The kernel alone (one launch of ``kernels._exact_launch``, CUDA events
  over repeated launches) at Q 1, 16 and 1,024, select mode (k 10 and
  64) and scores mode, for the source as it is and for variants built
  from it with a part changed: ``staged`` (up to 16 queries, the query
  parts staged with each stage's rows, split on the host, as above 768),
  ``n16`` (16-query blocks down to one query, no 8-query blocks).
* The host time of one Q 1 call's steps (no synchronisation between
  calls): the queries as the kernel takes them, the parts split on the
  host, the launch, the key merge and decode, the whole call.

Run on a card from the repository's root (about 1 min):
``python scripts/torch_int8_exact_probe.py``; the record goes to
``chiprun_out/int8_exact_probe.json``.
"""

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neumann_tpu_torch.ops import kernels as tk  # noqa: E402
from neumann_tpu_torch.ops.quant import (  # noqa: E402
    int8_cosine_row_mult,
    scalar_quantize,
)

ROWS, DIM, DEAD = 419_430, 768, 0.01
VARIANTS = {
    "source": [],
    "staged": [("const bool res = nq <= 16 && a.d <= kResK;",
                "const bool res = false;")],
    "n16": [("const int nq = a.n_q <= 8 ? 8 :",
             "const int nq = a.n_q <= 0 ? 8 :")],
}


def build_variants(out_dir: Path) -> dict:
    """Each variant's source built alone into a shared library."""
    src = (tk.CSRC_DIR / "int8_exact.cu").read_text()
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
        lib.neumann_int8_exact_select.argtypes = [
            vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i64, vp]
        lib.neumann_int8_exact_scores.argtypes = [
            vp, vp, vp, vp, i64, i32, i32, i32, i32, i64, vp]
        lib.neumann_int8_exact_select.restype = i32
        lib.neumann_int8_exact_scores.restype = i32
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int) -> float:
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


def host_ms(fn, reps: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    dev = torch.device("cuda")
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(ROWS, DIM, generator=g, device=dev)
    c, sc = scalar_quantize(x)
    rm = int8_cosine_row_mult(c, sc)
    rm[torch.rand(ROWS, generator=g, device=dev) < DEAD] = 0.0
    qs = x[torch.randint(0, ROWS, (1024,), generator=g, device=dev)] \
        + 0.1 * torch.randn(1024, DIM, generator=g, device=dev)
    del x
    qf = qs / qs.norm(dim=1, keepdim=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    live = rm > 0
    err = {}
    for q in (1, 16, 17, 1024):
        got = tk._exact_launch(c, rm, tk._exact_queries(qf[:q], DIM), q, 0,
                               False)
        ref = (qf[:q].double() @ c.double().T) * rm.double()
        plain = (qf[:q] @ c.float().T) * rm
        err[f"q{q}"] = dict(
            kernel=float((got.double() - ref)[:, live].abs().max()),
            plain=float((plain.double() - ref)[:, live].abs().max()))
        del got, ref, plain
    out["max_abs_err_vs_float64"] = err
    libs = build_variants(ROOT / "build" / "int8_exact_probe")
    times = {}
    for name, lib in libs.items():
        tk._lib = lib
        rec = {}
        for q, k, select, reps in ((1, 10, True, 400), (1, 0, False, 400),
                                   (16, 10, True, 200), (1024, 10, True, 10),
                                   (1024, 64, True, 10), (1024, 0, False, 10)):
            # the staged variant takes the parts, split on the host
            x = (tk._exact_parts(qf[:q], DIM) if name == "staged"
                 else tk._exact_queries(qf[:q], DIM))
            rec[f"q{q}_{'select_k%d' % k if select else 'scores'}_ms"] = \
                cuda_ms(lambda: tk._exact_launch(c, rm, x, q, k, select),
                        reps)
        times[name] = rec
        print(name, rec, flush=True)
    out["kernel_ms"] = times
    tk._lib = None
    q1 = qf[:1]
    x1 = tk._exact_queries(q1, DIM)
    keys = tk._exact_launch(c, rm, x1, 1, 10, True)
    out["host_ms_q1"] = dict(
        queries=host_ms(lambda: tk._exact_queries(q1, DIM)),
        parts_on_host=host_ms(lambda: tk._exact_parts(q1, DIM)),
        launch=host_ms(lambda: tk._exact_launch(c, rm, x1, 1, 10, True)),
        merge_decode=host_ms(lambda: tk.decode_score_keys(
            tk.merge_keys(None, keys, 10, largest=True))),
        call=host_ms(lambda: tk.int8_exact_topk(c, rm, q1, 10)))
    print(json.dumps(out), flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "int8_exact_probe.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
