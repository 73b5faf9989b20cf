"""The port's kernels, written by hand in CUDA C++ for Hopper, with their
plain PyTorch versions: every Pallas kernel of
``neumann_tpu/ops/pallas_kernels.py`` plus the pooled-bits scan step
that XLA fuses on the TPU.

* ``ivf_probe_scores`` (``csrc/ivf_probe.cu``) replaces the Pallas IVF
  probe kernel ``_ivf_probe_kernel`` (``ivf_probe_scores_pallas`` /
  ``ivf_windowed_topk_pallas``): the latency path's first pass.
* ``batched_probe`` (``csrc/batched_probe.cu``) replaces the Pallas
  top-2 kernel ``_batched_probe_kernel`` (``batched_probe_pallas``): the
  throughput path's first pass on the int8 tensor cores, packed
  strided-pool winners (top-2 a pool, or top-1: counted apart as
  ``batched_probe_top1``).
* ``int8_dot_scores`` (``csrc/int8_scores.cu``) replaces the Pallas
  ``_int8_kernel`` (``int8_dot_scores``): the int8 scan's block scores.
* ``int8_pooled_bits`` (``csrc/int8_scores.cu``) and ``f32_pooled_bits``
  (``csrc/f32_pooled.cu``) replace the XLA-fused pooled-bits steps of
  ``ops/quant.int8_pooled_topk`` / ``f32_pooled_topk``: consecutive
  pools, packed winner bits, scores never in device memory.
* ``hamming_scores`` (``csrc/hamming.cu``) replaces the Pallas
  ``_hamming_kernel`` (``hamming_scores``), and ``hamming_topk``
  (``csrc/hamming_topk.cu``) replaces ``hamming_topk_pallas`` with the
  top-k fused in, no [Q, N] distances in device memory; both on the 1-bit
  tensor cores (``csrc/mma_b1.cuh``), for any row width.
* ``pq_adc_topk`` and ``pq_adc_scores`` (``csrc/pq_adc.cu``, one kernel
  in two modes) replace the XLA-fused ADC search of
  ``neumann_tpu/ops/pq.py`` (``_adc_search_fn``: the sums and
  ``lax.top_k``) and of the ``pq`` storage of
  ``neumann_tpu/ops/ivf.IVFIndex.search``: per-query lookup tables summed
  over a code matrix, in full or over gathered candidates, the top-k
  selected inside the kernel (k up to 64) or the scores written.
* ``int8_exact_topk`` (``csrc/int8_exact.cu``, one kernel in two modes)
  replaces the jitted ``int8_exact_topk`` of ``neumann_tpu/ops/quant.py``
  (the exact scan of the IVF delta plane): f32 cosine scores of int8 rows
  against f32 queries, the top-k selected inside the kernel (k up to 64)
  or the scores written.

Every wrapper takes its plain version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches per kernel (a run can prove the main
path went through them); the plain versions never touch it.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` from
the sources in ``csrc/`` (one ``nvcc -c`` per source, all at once, then
one link) into ``build/neumann_tpu_torch/`` at the root of the
checkout, and bound with ``ctypes`` (plain C entry points that return
``cudaGetLastError()``). Outputs are allocated here with
``torch.empty`` and the kernels run on the current stream.

Differences from the Pallas wrappers: the per-query trace-time unroll
is gone (the query is a grid axis), and the final cut of
``ivf_windowed_topk`` is an exact top-k in ``lax.top_k``'s order (the
JAX package's XLA core) instead of ``approx_max_k`` — its recall is at
least that of the approximate cut.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from neumann_tpu_torch.ops.scan import _topk_stable, stable_keys

LAUNCHES = {"ivf_probe": 0, "batched_probe": 0, "batched_probe_top1": 0,
            "int8_dot_scores": 0, "int8_pooled_bits": 0,
            "f32_pooled_bits": 0, "hamming_scores": 0, "hamming_topk": 0,
            "pq_adc": 0, "pq_adc_select": 0, "int8_exact_select": 0,
            "int8_exact_scores": 0}

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ivf_probe.cu", "batched_probe.cu", "int8_scores.cu",
           "f32_pooled.cu", "hamming.cu", "hamming_topk.cu", "pq_adc.cu",
           "int8_exact.cu")
HEADERS = ("pooled_bits.cuh", "mma_s8.cuh", "mma_b1.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neumann_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# strided pools per window in the batched kernel's packed output
_POOL_LANES = 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def build_kernels(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library.

    The shared object's name carries a hash of the sources and flags, so
    an edited source rebuilds and a stale build is never loaded.
    ``verbose`` adds ``-Xptxas=-v`` and prints nvcc's report (registers,
    shared memory, spills per kernel)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES + HEADERS:
            digest.update((CSRC_DIR / name).read_bytes())
        tag = digest.hexdigest()[:16]
        so = BUILD_DIR / f"libneumann_kernels-{tag}.so"
        if not so.exists() or verbose:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc, pid = _nvcc(), os.getpid()
            objs = [BUILD_DIR / f"{Path(n).stem}-{tag}.{pid}.o"
                    for n in SOURCES]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                 "-c", "-o", str(o), str(CSRC_DIR / n)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for n, o in zip(SOURCES, objs)]
            logs = [(n, p.communicate()[0], p.returncode)
                    for n, p in zip(SOURCES, procs)]
            failed = [f"{n} ({rc}):\n{log}" for n, log, rc in logs if rc]
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            if verbose:
                print("".join(log for _, log, _ in logs), flush=True)
            tmp = so.with_suffix(f".{pid}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            for o in objs:
                o.unlink(missing_ok=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):"
                                   f"\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args in (
                ("neumann_ivf_probe_scores",
                 [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, vp]),
                ("neumann_batched_probe",
                 [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]),
                ("neumann_int8_dot_scores",
                 [vp, vp, vp, vp, vp, i32, i64, i32, vp]),
                ("neumann_int8_pooled_bits",
                 [vp, vp, vp, vp, vp, vp, i32, i64, i32, i32, vp]),
                ("neumann_f32_pooled_bits",
                 [vp, vp, vp, vp, vp, vp, i32, i64, i32, i32, vp]),
                ("neumann_hamming_scores", [vp, vp, vp, i64, i32, i32, vp]),
                ("neumann_hamming_topk",
                 [vp, vp, vp, vp, vp, i64, i32, i32, i32, i64, i32, i32,
                  i32, i32, i32, vp]),
                ("neumann_hamming_topk_unselected",
                 [vp, vp, vp, vp, vp, i64, i32, i32, i32, i64, i32, i32,
                  i32, i32, i32, vp]),
                ("neumann_b1_mma_rate", [i32, i32, vp, vp]),
                ("neumann_pq_adc_scores",
                 [vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
                  i32, i64, i64, vp]),
                ("neumann_pq_adc_select",
                 [vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32,
                  i32, i32, i32, i64, i64, vp]),
                ("neumann_int8_exact_select",
                 [vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i64, vp]),
                ("neumann_int8_exact_scores",
                 [vp, vp, vp, vp, i64, i32, i32, i32, i32, i64, vp])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i32
        _lib = lib
        return lib


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name}: want {ndim}-D {dtype}, got "
                         f"{t.ndim}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _launch_ready(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the kernel")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the kernel")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# kernel 1: IVF probe scores (the latency path)
# ---------------------------------------------------------------------------

def ivf_probe_scores_plain(buf, rmult, start_blocks, queries, window: int):
    """Plain PyTorch version of the probe kernel (see
    ``ivf_probe_scores``). One query's candidates at a time bounds the
    f32 gather to nprobe x window x d."""
    q, nprobe = start_blocks.shape
    n = buf.shape[0]
    qb = queries.float().to(torch.bfloat16).float()
    pos = ((start_blocks.long() * 128)[:, :, None]
           + torch.arange(window, device=buf.device)).reshape(q, -1)
    inb = pos < n
    pos = pos.clamp(0, n - 1)
    out = torch.empty((q, nprobe * window), dtype=torch.float32,
                      device=buf.device)
    for i in range(q):
        dots = buf[pos[i]].float() @ qb[i]
        rm = rmult[pos[i]]
        out[i] = torch.where(inb[i] & (rm > 0), dots * rm,
                             torch.full_like(dots, float("-inf")))
    return out


def ivf_probe_scores(buf, rmult, start_blocks, queries, window: int):
    """Scores of every probed window row.

    buf [N, d] int8 cluster-sorted corpus, rmult [N] f32 cosine row
    multipliers (0 = dead row), start_blocks [Q, nprobe] (or [nprobe])
    int32 window starts // 128, queries [Q, d] f32 (normalized). Returns
    [Q, nprobe * window] f32: bf16(query) . row in f32, times rmult,
    -inf where rmult <= 0 or the row is past N."""
    if start_blocks.ndim == 1:
        start_blocks = start_blocks[None, :]
    dev = buf.device
    _check("buf", buf, torch.int8, 2, dev)
    _check("rmult", rmult, torch.float32, 1, dev)
    _check("start_blocks", start_blocks, torch.int32, 2, dev)
    _check("queries", queries, torch.float32, 2, dev)
    n, d = buf.shape
    q, nprobe = start_blocks.shape
    if window % 128 or queries.shape != (q, d) or rmult.shape[0] != n:
        raise ValueError(
            f"probe shapes: buf {tuple(buf.shape)}, rmult "
            f"{tuple(rmult.shape)}, start_blocks {(q, nprobe)}, queries "
            f"{tuple(queries.shape)}, window {window} (multiple of 128)")
    if dev.type == "cpu":
        return ivf_probe_scores_plain(buf, rmult, start_blocks, queries,
                                      window)
    if dev.type != "cuda":
        raise ValueError(f"ivf_probe_scores: unsupported device {dev}")
    if d % 16 or q > 65535 or nprobe > 65535:
        raise ValueError(f"probe kernel needs d % 16 == 0 and Q, nprobe "
                         f"<= 65535 (d={d}, Q={q}, nprobe={nprobe})")
    for name, t in (("buf", buf), ("rmult", rmult),
                    ("start_blocks", start_blocks), ("queries", queries)):
        _launch_ready(name, t)
    lib = build_kernels()
    out = torch.empty((q, nprobe * window), dtype=torch.float32, device=dev)
    if q and nprobe:
        with torch.cuda.device(dev):
            err = lib.neumann_ivf_probe_scores(
                buf.data_ptr(), rmult.data_ptr(), start_blocks.data_ptr(),
                queries.data_ptr(), out.data_ptr(), n, d, q, nprobe, window,
                _stream())
        _raise_on(err, "ivf_probe")
        LAUNCHES["ivf_probe"] += 1
    return out


def ivf_windowed_topk(buf, rmult, cents, starts, queries, k: int,
                      nprobe: int, window: int):
    """Windowed-IVF first pass through the probe kernel.

    Requires 128-aligned window starts and a window that is a multiple
    of 128 (``DeviceIVFInt8`` lays the corpus out that way). Returns
    (scores [Q, k], positions [Q, k] int32 in sorted-buffer
    coordinates); positions may repeat across overlapping windows. Both
    cuts are in ``lax.top_k``'s order, as the JAX package's XLA core
    makes them (``_topk_stable``; equal candidates by their place in
    the probed windows)."""
    qn = queries / queries.norm(dim=1, keepdim=True).clamp_min(1e-30)
    probe = _topk_stable(qn @ cents.T, nprobe)[1]
    sb = torch.div(starts[probe], 128, rounding_mode="floor").int()
    scores = ivf_probe_scores(buf, rmult, sb.contiguous(), qn.contiguous(),
                              window)
    pos = ((sb.long() * 128)[:, :, None]
           + torch.arange(window, device=buf.device)).reshape(qn.shape[0], -1)
    s, i = _topk_stable(scores, min(k, scores.shape[1]))
    return s, torch.gather(pos, 1, i).int()


# ---------------------------------------------------------------------------
# kernel 2: batched top-2 probe (the throughput path)
# ---------------------------------------------------------------------------

def _fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """Single-rounding f32 fused multiply-add a * b + c (a, b f32; c an
    f32 tensor that broadcasts, or a float).

    The product is exact in float64 (24 + 24 significant bits); the
    float64 sum is made round-to-odd (TwoSum error, then one ulp toward
    it on an even mantissa), and round-to-odd followed by one rounding
    to f32 is the correctly rounded f32 result (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(bump, torch.nextafter(s, toward), s).float()


def batched_probe_plain(buf, rmult2d, qsel, scmult, window: int,
                        top2: bool = False, windows_per_step: int = 64):
    """Plain PyTorch version of the batched kernel (see
    ``batched_probe``), bit-identical to it and to the Pallas kernel.

    The int8 dots are exact in float64 and are rounded to f32 as the
    kernel's int32 -> f32 conversion does; ``s`` is one fused
    multiply-add, as XLA computes ``dots * (mult * rm) + 2.0``. Windows
    go in steps to bound the float64 temporaries."""
    n_win, q_cap, d = qsel.shape
    pool = window // _POOL_LANES
    low_mask = ~(pool - 1)
    lanes = 2 * _POOL_LANES if top2 else _POOL_LANES
    out = torch.empty((n_win, q_cap, lanes), dtype=torch.int32,
                      device=qsel.device)
    member = torch.div(torch.arange(window, device=qsel.device),
                       _POOL_LANES, rounding_mode="floor").int()
    for c0 in range(0, n_win, windows_per_step):
        c1 = min(n_win, c0 + windows_per_step)
        rows = buf[c0 * window:c1 * window].reshape(c1 - c0, window, d)
        dots = torch.bmm(qsel[c0:c1].double(),
                         rows.double().transpose(1, 2)).float()
        rm = rmult2d[c0:c1, None, :]
        s = _fma_f32(dots, scmult[c0:c1, :, None] * rm, 2.0)
        s = torch.where(rm > 0, s, torch.zeros_like(s))
        bits = ((s.view(torch.int32) & low_mask) | member).reshape(
            c1 - c0, q_cap, pool, _POOL_LANES)
        w1 = torch.zeros_like(bits[:, :, 0])
        w2 = torch.zeros_like(w1)
        for a in range(pool):
            x = bits[:, :, a]
            if top2:
                w2 = torch.maximum(w2, torch.minimum(w1, x))
            w1 = torch.maximum(w1, x)
        out[c0:c1] = torch.cat([w1, w2], dim=2) if top2 else w1
    return out


def batched_probe(buf, rmult2d, qsel, scmult, window: int,
                  top2: bool = False):
    """Fused batched-IVF first pass over ALL windows.

    buf     [C*window, d] int8 fixed-window corpus.
    rmult2d [C, window] f32 cosine row multipliers (0 = dead row).
    qsel    [C, q_cap, d] int8 per-window selected queries.
    scmult  [C, q_cap] f32 per-slot query scales (0 = empty slot).
    Returns packed winner bits [C, q_cap, 128] int32: 128 strided pools
    of ``window // 128`` rows each (member i of pool b is row
    i * 128 + b); decode with ``decode_strided_pool_bits``. top2=True:
    [C, q_cap, 256] with each pool's runner-up in lanes 128:."""
    dev = qsel.device
    _check("buf", buf, torch.int8, 2, dev)
    _check("rmult2d", rmult2d, torch.float32, 2, dev)
    _check("qsel", qsel, torch.int8, 3, dev)
    _check("scmult", scmult, torch.float32, 2, dev)
    n_win, q_cap, d = qsel.shape
    pool = window // _POOL_LANES
    if (window % _POOL_LANES or pool & (pool - 1)
            or buf.shape != (n_win * window, d)
            or rmult2d.shape != (n_win, window)
            or scmult.shape != (n_win, q_cap)):
        raise ValueError(
            f"batched probe shapes: buf {tuple(buf.shape)}, rmult2d "
            f"{tuple(rmult2d.shape)}, qsel {tuple(qsel.shape)}, scmult "
            f"{tuple(scmult.shape)}, window {window} (a power-of-two "
            f"multiple of 128)")
    if dev.type == "cpu":
        return batched_probe_plain(buf, rmult2d, qsel, scmult, window, top2)
    if dev.type != "cuda":
        raise ValueError(f"batched_probe: unsupported device {dev}")
    if d % 16:
        raise ValueError(f"batched kernel needs d % 16 == 0 (d={d})")
    for name, t in (("buf", buf), ("rmult2d", rmult2d), ("qsel", qsel),
                    ("scmult", scmult)):
        _launch_ready(name, t)
    lib = build_kernels()
    lanes = 2 * _POOL_LANES if top2 else _POOL_LANES
    out = torch.empty((n_win, q_cap, lanes), dtype=torch.int32, device=dev)
    if n_win and q_cap:
        with torch.cuda.device(dev):
            err = lib.neumann_batched_probe(
                qsel.data_ptr(), buf.data_ptr(), scmult.data_ptr(),
                rmult2d.data_ptr(), out.data_ptr(), n_win, q_cap, d, window,
                int(top2), _stream())
        _raise_on(err, "batched_probe")
        LAUNCHES["batched_probe" if top2 else "batched_probe_top1"] += 1
    return out


def decode_strided_pool_bits(wb, window: int):
    """(scores f32, within-window positions int32, -1 = dead) from the
    packed strided-pool winner bits (last axis = 128 pools, or 256 for
    top-2 output, whose lanes 128: are the runners-up)."""
    pool = window // _POOL_LANES
    dead = wb < 0x3F800000                  # below bitcast(1.0)
    scores = torch.where(
        dead, torch.full(wb.shape, float("-inf"), device=wb.device),
        (wb & ~(pool - 1)).view(torch.float32) - 2.0)
    lane = torch.arange(wb.shape[-1], device=wb.device,
                        dtype=torch.int32) % _POOL_LANES
    pos = torch.where(dead, torch.full_like(wb, -1),
                      (wb & (pool - 1)) * _POOL_LANES + lane)
    return scores, pos


# ---------------------------------------------------------------------------
# kernels 4 and 5: int8 scores and int8 pooled bits (one dot loop)
# ---------------------------------------------------------------------------

# an f32 matmul of int8 values is exact while every partial sum is an
# integer of magnitude below 2^24: |dot| <= 127^2 d
_EXACT_F32_DIM = (1 << 24) // (127 * 127)
# the plain versions bound their [Q, rows] temporaries to this many
# elements per step
_PLAIN_STEP_ELEMS = 1 << 24


def _int8_dots(qq: torch.Tensor, cq: torch.Tensor) -> torch.Tensor:
    """Exact int8 dots [Q, N] as f32, as the kernels' int32 sums
    converted to f32 (float64 past the exact-f32 depth)."""
    if qq.shape[1] <= _EXACT_F32_DIM:
        return qq.float() @ cq.float().T
    return (qq.double() @ cq.double().T).float()


def _row_steps(n: int, q: int, align: int = 1):
    step = max(align, _PLAIN_STEP_ELEMS // max(q, 1) // align * align)
    return ((r0, min(n, r0 + step)) for r0 in range(0, n, step))


def _check_int8_scan(corpus_q, row_mult, queries_q, q_mult, dev):
    _check("corpus_q", corpus_q, torch.int8, 2, dev)
    _check("row_mult", row_mult, torch.float32, 1, dev)
    _check("queries_q", queries_q, torch.int8, 2, dev)
    _check("q_mult", q_mult, torch.float32, 1, dev)
    if (queries_q.shape[1] != corpus_q.shape[1]
            or row_mult.shape[0] != corpus_q.shape[0]
            or q_mult.shape[0] != queries_q.shape[0]):
        raise ValueError(
            f"int8 scan shapes: corpus {tuple(corpus_q.shape)}, row_mult "
            f"{tuple(row_mult.shape)}, queries {tuple(queries_q.shape)}, "
            f"q_mult {tuple(q_mult.shape)}")


def _cuda_ready(name: str, dev, d: int, d_mult: int, q: int, tensors):
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if d % d_mult or q > 65535 * 16:
        raise ValueError(f"{name} kernel needs d % {d_mult} == 0 and Q <= "
                         f"{65535 * 16} (d={d}, Q={q})")
    for tname, t in tensors:
        _launch_ready(tname, t)


def int8_dot_scores_plain(corpus_q, row_mult, queries_q, q_mult):
    """Plain PyTorch version of ``int8_dot_scores``, bit-identical to it
    and to the Pallas kernel: exact dots, then two f32 roundings."""
    q, n = queries_q.shape[0], corpus_q.shape[0]
    out = torch.empty((q, n), dtype=torch.float32, device=corpus_q.device)
    for r0, r1 in _row_steps(n, q):
        out[:, r0:r1] = ((_int8_dots(queries_q, corpus_q[r0:r1])
                          * q_mult[:, None]) * row_mult[None, r0:r1])
    return out


def int8_dot_scores(corpus_q, row_mult, queries_q, q_mult):
    """[Q, N] f32 fused-dequant scores ``(float(q . c) * q_mult) *
    row_mult`` (the Pallas ``int8_dot_scores``; q_mult may be [Q, 1] and
    row_mult [1, N] as there).

    corpus_q [N, d] int8, queries_q [Q, d] int8; the dots are exact
    int32 sums, so the output is bit-exact."""
    q_mult, row_mult = q_mult.reshape(-1), row_mult.reshape(-1)
    dev = corpus_q.device
    _check_int8_scan(corpus_q, row_mult, queries_q, q_mult, dev)
    if dev.type == "cpu":
        return int8_dot_scores_plain(corpus_q, row_mult, queries_q, q_mult)
    (n, d), q = corpus_q.shape, queries_q.shape[0]
    _cuda_ready("int8_dot_scores", dev, d, 64, q,
                (("corpus_q", corpus_q), ("row_mult", row_mult),
                 ("queries_q", queries_q), ("q_mult", q_mult)))
    lib = build_kernels()
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q and n:
        with torch.cuda.device(dev):
            err = lib.neumann_int8_dot_scores(
                queries_q.data_ptr(), corpus_q.data_ptr(), q_mult.data_ptr(),
                row_mult.data_ptr(), out.data_ptr(), q, n, d, _stream())
        _raise_on(err, "int8_dot_scores")
        LAUNCHES["int8_dot_scores"] += 1
    return out


def _check_pool(pool: int, n: int) -> None:
    if not 8 <= pool <= 4096 or pool & (pool - 1) or n % pool:
        raise ValueError(f"pool must be a power of two in [8, 4096] that "
                         f"divides N (pool={pool}, N={n})")


def _pack_pool_max(a, row_mult, bias, r0: int, pool: int):
    """The pooled epilogue on scores a = dots * q_mult of rows r0..:
    fma(a, rm, bias) as one rounding, bitcast, in-pool index in the low
    log2(pool) bits, max per pool."""
    s = _fma_f32(a, row_mult[None, :], bias[None, :])
    member = (torch.arange(r0, r0 + a.shape[1], device=a.device)
              & (pool - 1)).int()
    bits = (s.view(torch.int32) & ~(pool - 1)) | member
    return bits.reshape(a.shape[0], -1, pool).amax(dim=2)


def int8_pooled_bits_plain(corpus_q, row_mult, bias, queries_q, q_mult,
                           pool: int):
    """Plain PyTorch version of ``int8_pooled_bits``, bit-identical to
    it and to the JAX package's fused step (exact dots, f32 product,
    exactly rounded f32 FMA)."""
    q, n = queries_q.shape[0], corpus_q.shape[0]
    out = torch.empty((q, n // pool), dtype=torch.int32,
                      device=corpus_q.device)
    for r0, r1 in _row_steps(n, q, pool):
        a = _int8_dots(queries_q, corpus_q[r0:r1]) * q_mult[:, None]
        out[:, r0 // pool:r1 // pool] = _pack_pool_max(
            a, row_mult[r0:r1], bias[r0:r1], r0, pool)
    return out


def int8_pooled_bits(corpus_q, row_mult, bias, queries_q, q_mult,
                     pool: int):
    """Packed pool winners of the int8 cosine scan (the XLA-fused step of
    the JAX package's ``int8_pooled_topk``).

    corpus_q [N, d] int8, row_mult [N] f32 (cosine multipliers), bias
    [N] f32 (2.0 live, -1e30 dead), queries_q [Q, d] int8, q_mult [Q]
    f32. Pools are ``pool`` CONSECUTIVE rows (a power of two in [8,
    4096] dividing N). Returns [Q, N / pool] int32: per pool the max of
    ``(bitcast(fma(float(dot) * q_mult, rm, bias)) & ~(pool - 1)) |
    (row % pool)``; decode with ``ops/quant._pooled_bits_select``."""
    dev = corpus_q.device
    _check_int8_scan(corpus_q, row_mult, queries_q, q_mult, dev)
    _check("bias", bias, torch.float32, 1, dev)
    (n, d), q = corpus_q.shape, queries_q.shape[0]
    _check_pool(pool, n)
    if bias.shape[0] != n:
        raise ValueError(f"bias {tuple(bias.shape)} for {n} rows")
    if dev.type == "cpu":
        return int8_pooled_bits_plain(corpus_q, row_mult, bias, queries_q,
                                      q_mult, pool)
    _cuda_ready("int8_pooled_bits", dev, d, 64, q,
                (("corpus_q", corpus_q), ("row_mult", row_mult),
                 ("bias", bias), ("queries_q", queries_q),
                 ("q_mult", q_mult)))
    lib = build_kernels()
    out = torch.empty((q, n // pool), dtype=torch.int32, device=dev)
    if q and n:
        with torch.cuda.device(dev):
            err = lib.neumann_int8_pooled_bits(
                queries_q.data_ptr(), corpus_q.data_ptr(), q_mult.data_ptr(),
                row_mult.data_ptr(), bias.data_ptr(), out.data_ptr(), q, n,
                d, pool, _stream())
        _raise_on(err, "int8_pooled_bits")
        LAUNCHES["int8_pooled_bits"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 6: f32 pooled bits
# ---------------------------------------------------------------------------

def f32_pooled_bits_plain(corpus, row_mult, bias, queries, q_mult,
                          pool: int):
    """Plain PyTorch version of ``f32_pooled_bits``: an f32 matmul (no
    TF32), then the same epilogue. Its dots are summed in another order
    than the kernel's, so the two agree to a tolerance, not bit for
    bit."""
    q, n = queries.shape[0], corpus.shape[0]
    out = torch.empty((q, n // pool), dtype=torch.int32, device=corpus.device)
    for r0, r1 in _row_steps(n, q, pool):
        a = (queries @ corpus[r0:r1].T) * q_mult[:, None]
        out[:, r0 // pool:r1 // pool] = _pack_pool_max(
            a, row_mult[r0:r1], bias[r0:r1], r0, pool)
    return out


def f32_pooled_bits(corpus, row_mult, bias, queries, q_mult, pool: int):
    """Packed pool winners of the f32 cosine scan (the XLA-fused step of
    the JAX package's ``f32_pooled_topk``): as ``int8_pooled_bits`` with
    an f32 corpus [N, d] and f32 queries [Q, d], dots in full f32."""
    dev = corpus.device
    _check("corpus", corpus, torch.float32, 2, dev)
    _check("row_mult", row_mult, torch.float32, 1, dev)
    _check("bias", bias, torch.float32, 1, dev)
    _check("queries", queries, torch.float32, 2, dev)
    _check("q_mult", q_mult, torch.float32, 1, dev)
    (n, d), q = corpus.shape, queries.shape[0]
    _check_pool(pool, n)
    if (queries.shape[1] != d or row_mult.shape[0] != n
            or bias.shape[0] != n or q_mult.shape[0] != q):
        raise ValueError(
            f"f32 pooled shapes: corpus {tuple(corpus.shape)}, row_mult "
            f"{tuple(row_mult.shape)}, bias {tuple(bias.shape)}, queries "
            f"{tuple(queries.shape)}, q_mult {tuple(q_mult.shape)}")
    if dev.type == "cpu":
        return f32_pooled_bits_plain(corpus, row_mult, bias, queries, q_mult,
                                     pool)
    _cuda_ready("f32_pooled_bits", dev, d, 16, q,
                (("corpus", corpus), ("row_mult", row_mult), ("bias", bias),
                 ("queries", queries), ("q_mult", q_mult)))
    lib = build_kernels()
    out = torch.empty((q, n // pool), dtype=torch.int32, device=dev)
    if q and n:
        with torch.cuda.device(dev):
            err = lib.neumann_f32_pooled_bits(
                queries.data_ptr(), corpus.data_ptr(), q_mult.data_ptr(),
                row_mult.data_ptr(), bias.data_ptr(), out.data_ptr(), q, n,
                d, pool, _stream())
        _raise_on(err, "f32_pooled_bits")
        LAUNCHES["f32_pooled_bits"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 3: hamming distances
# ---------------------------------------------------------------------------

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 bit pattern (SWAR; every mask clears the
    sign bits an arithmetic shift brings in)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + (x >> 24)


def hamming_scores_plain(corpus_bits, query_bits):
    """Plain PyTorch version of ``hamming_scores`` (exact)."""
    (n, w), q = corpus_bits.shape, query_bits.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=corpus_bits.device)
    for r0, r1 in _row_steps(n, q * w):
        x = query_bits[:, None, :] ^ corpus_bits[None, r0:r1, :]
        out[:, r0:r1] = _popcount32(x).sum(dim=2, dtype=torch.int32)
    return out


def _check_hamming(corpus_bits, query_bits):
    dev = corpus_bits.device
    _check("corpus_bits", corpus_bits, torch.int32, 2, dev)
    _check("query_bits", query_bits, torch.int32, 2, dev)
    if query_bits.shape[1] != corpus_bits.shape[1]:
        raise ValueError(f"hamming shapes: corpus {tuple(corpus_bits.shape)}"
                         f", queries {tuple(query_bits.shape)}")


def _hamming_cuda_ready(name: str, corpus_bits, query_bits):
    dev = corpus_bits.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if corpus_bits.shape[1] % 4:
        raise ValueError(f"{name} kernel needs W % 4 == 0 "
                         f"(W={corpus_bits.shape[1]})")
    for tname, t in (("corpus_bits", corpus_bits), ("query_bits", query_bits)):
        _launch_ready(tname, t)


def hamming_scores(corpus_bits, query_bits):
    """[Q, N] int32 hamming distances (the Pallas ``hamming_scores``).

    corpus_bits [N, W] and query_bits [Q, W] int32 bit patterns (the
    JAX package's uint32 words, same bits). No row padding and no
    word-major transpose: the kernel reads rows as stored."""
    _check_hamming(corpus_bits, query_bits)
    dev = corpus_bits.device
    (n, w), q = corpus_bits.shape, query_bits.shape[0]
    if dev.type == "cpu":
        return hamming_scores_plain(corpus_bits, query_bits)
    _hamming_cuda_ready("hamming_scores", corpus_bits, query_bits)
    lib = build_kernels()
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    if q and n:
        with torch.cuda.device(dev):
            err = lib.neumann_hamming_scores(
                corpus_bits.data_ptr(), query_bits.data_ptr(), out.data_ptr(),
                n, q, w, _stream())
        _raise_on(err, "hamming_scores")
        LAUNCHES["hamming_scores"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 7: hamming top-k, fused
# ---------------------------------------------------------------------------

# the fused kernel's largest k (it keeps k keys a query in shared
# memory); ops/quant.hamming_topk takes hamming_scores above it
HAMMING_TOPK_CAP = 64
# csrc/hamming_topk.cu's limits: queries a consumer warp (the M tile),
# consumer warps, rows a warp a stage and a stage, ring stages, the
# candidate buffer's base, the widest row and a block's shared memory
_HT_TILE = 16
_HT_WARPS = 8
_HT_ROWS_PER_WARP = (64, 32, 16, 8)
_HT_MAX_STAGE_ROWS = 128
_HT_STAGES = (3, 16)
_HT_BUF_BASE = 64
_HT_MAX_WORDS = 1 << 16
_HT_SMEM = 232448
# rows a hamming_scores launch of the route for rows too wide for the
# fused kernel's stages (about 1,390 words at k 64)
_HT_WIDE_BLOCK = 1 << 17
# selection keys, int64, distinct for distinct rows, so a smallest-k (or
# greatest-k) over them is exact and ordered as lax.top_k orders equal
# scores (by ascending row): hamming keys distance * 2^32 + row, ascending
# key order (distance ascending, row ascending), _DEAD_KEY for rows that
# cannot be selected; f32 score keys the score's bits made
# order-preserving as an int32 (-0.0 counted as +0.0) above the row's
# complement, descending key order (score descending, row ascending)
_KEY_SHIFT = 1 << 32
_DEAD_KEY = torch.iinfo(torch.int64).max


def hamming_keys(dist: torch.Tensor, r0: int, mask=None) -> torch.Tensor:
    """Selection keys [Q, B] int64 of a [Q, B] int32 distance block of
    rows r0 .. r0 + B - 1; rows where ``mask`` [N] is False get
    _DEAD_KEY."""
    b = dist.shape[1]
    keys = dist.long() * _KEY_SHIFT + torch.arange(r0, r0 + b,
                                                   device=dist.device)
    if mask is not None:
        keys = keys.masked_fill(~mask[None, r0:r0 + b], _DEAD_KEY)
    return keys


def merge_keys(best, keys: torch.Tensor, k: int,
               largest: bool = False) -> torch.Tensor:
    """The k smallest (``largest``: greatest) of ``best`` and ``keys``
    along dim 1, sorted. Keys of live rows are distinct, so the result
    does not depend on the selection's order among equal values."""
    if best is not None:
        keys = torch.cat([best, keys], dim=1)
    return torch.topk(keys, min(k, keys.shape[1]), dim=1,
                      largest=largest).values


def decode_hamming_keys(keys: torch.Tensor):
    """(scores [Q, k] f32 = -distance, ids [Q, k] int32) of sorted
    selection keys; -inf / -1 for _DEAD_KEY."""
    dead = keys == _DEAD_KEY
    scores = -torch.div(keys, _KEY_SHIFT, rounding_mode="floor").float()
    return (scores.masked_fill(dead, float("-inf")),
            (keys % _KEY_SHIFT).int().masked_fill(dead, -1))


def score_keys(s: torch.Tensor, r0: int) -> torch.Tensor:
    """Selection keys [Q, B] int64 of f32 scores [Q, B] of rows r0 ..."""
    b = (s + 0.0).view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    rows = torch.arange(r0, r0 + s.shape[1], device=s.device)
    return b.long() * _KEY_SHIFT + (_KEY_SHIFT - 1 - rows)


def decode_score_keys(keys: torch.Tensor):
    """(scores f32, rows int64) of ``score_keys`` keys."""
    hi = torch.div(keys, _KEY_SHIFT, rounding_mode="floor")
    b = hi.int()
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return b.view(torch.float32), _KEY_SHIFT - 1 - (keys - hi * _KEY_SHIFT)


def hamming_topk_plain(corpus_bits, query_bits, mask, k: int):
    """Plain PyTorch version of ``hamming_topk``: distances in row steps,
    a keyed merge after each."""
    (n, w), q = corpus_bits.shape, query_bits.shape[0]
    best = torch.empty((q, 0), dtype=torch.int64, device=corpus_bits.device)
    for r0, r1 in _row_steps(n, q * w):
        best = merge_keys(best, hamming_keys(
            hamming_scores_plain(corpus_bits[r0:r1], query_bits), r0, mask),
            k)
    return decode_hamming_keys(best)


def _ht_max_span(w: int) -> int:
    """The most rows one block of the fused kernel spans: its 32-bit keys
    keep a distance (up to 32 W) above the row in the group, 20 bits of
    row up to W 64 (as csrc/hamming_topk.cu), clz(32 W) above: 2^20 rows
    up to W 127, 2^18 at W 256."""
    return 1 << min(20, 32 - (32 * w).bit_length())


def _ht_stride(w: int, tiles: int) -> int:
    """Words a row of the kernel's ring: with more than one query tile the
    least >= W that is 8 mod 16, so a half warp's 8-byte loads of four
    rows hit distinct banks; with one, W (a stage is one bulk copy)."""
    return w + (24 - w % 16) % 16 if tiles > 1 else w


def _ht_smem(w: int, k: int, tiles: int, slices: int, rw: int,
             stages: int) -> int:
    """Shared-memory bytes of one block (csrc/hamming_topk.cu ``layout``):
    mbarriers, the A fragments, the ring and its row popcounts, popc(q),
    each consumer warp's thresholds, counts, best keys and buffer, and the
    rows' mask bytes."""
    steps, rows, warps = -(-w // 8), slices * rw, tiles * slices
    return (3 * _HT_STAGES[1] * 8 + tiles * steps * 32 * 16
            + stages * rows * (_ht_stride(w, tiles) + 1) * 4
            + tiles * _HT_TILE * 4
            + warps * _HT_TILE * (2 + k + _HT_BUF_BASE + rw) * 4
            + stages * rows)


def _hamming_groups(n: int, q: int, w: int, k: int, sms: int):
    """The fused kernel's plan: (tiles, slices, rows a warp a stage,
    stages, groups, span), or None where no plan fits shared memory.

    A block holds ``tiles`` tiles of 16 queries (up to 8: the corpus
    crosses from L2 once per 128 queries) and runs each over ``slices``
    row slices (8 // tiles where shared memory allows, so small cohorts
    keep all 8 consumer warps busy); a stage holds slices * rw <= 128
    rows. Each is cut, in that order of preference, until 3 stages fit;
    the ring then takes up to 16. Row groups: one block a SM over the
    query blocks, each spanning a multiple of a stage's rows and at most
    ``_ht_max_span(w)`` rows, so keys inside a warp stay 32 bits."""
    if w > _HT_MAX_WORDS:
        return None
    top = 1
    while top < min(_HT_WARPS, -(-q // _HT_TILE)):
        top *= 2
    tiles = top
    while tiles >= 1:
        slices = _HT_WARPS // tiles
        while slices >= 1:
            for rw in _HT_ROWS_PER_WARP:
                if slices * rw > _HT_MAX_STAGE_ROWS:
                    continue
                fits = [s for s in range(_HT_STAGES[0], _HT_STAGES[1] + 1)
                        if _ht_smem(w, k, tiles, slices, rw, s) <= _HT_SMEM]
                if fits:
                    rows = slices * rw
                    qblocks = -(-q // (_HT_TILE * tiles))
                    passes = -(-n // rows)
                    groups = min(passes, max(1, sms // qblocks))
                    span = min(_ht_max_span(w),
                               -(-passes // groups) * rows)
                    return (tiles, slices, rw, fits[-1], -(-n // span),
                            span)
            slices //= 2
        tiles //= 2
    return None


def _hamming_topk_launch(corpus_bits, query_bits, mask, k: int, plan,
                         out, gthr, select: bool = True) -> None:
    """One launch of the fused kernel with ``plan`` into ``out`` [Q,
    groups * slices * k] int64, ``gthr`` [Q] int64 its shared thresholds
    (set by the entry point); ``select`` False is the measurement launch
    with nothing selected. Raises on a CUDA error."""
    tiles, slices, rw, stages, groups, span = plan
    (n, w), q = corpus_bits.shape, query_bits.shape[0]
    lib = build_kernels()
    entry = (lib.neumann_hamming_topk if select
             else lib.neumann_hamming_topk_unselected)
    with torch.cuda.device(corpus_bits.device):
        err = entry(corpus_bits.data_ptr(), query_bits.data_ptr(),
                    0 if mask is None else mask.data_ptr(), out.data_ptr(),
                    gthr.data_ptr(), n, q, w, k, span, groups, tiles, slices,
                    rw, stages, _stream())
    _raise_on(err, "hamming_topk")


def hamming_topk(corpus_bits, query_bits, mask, k: int):
    """Top-k rows by hamming distance in one launch over the whole corpus,
    the distances on the 1-bit tensor cores and never in device memory
    (the JAX package's ``hamming_topk_pallas``, whose Pallas kernel writes
    the [Q, N] distances and leaves the top-k to XLA).

    corpus_bits [N, W] / query_bits [Q, W] int32 bit patterns, mask [N]
    bool or None, 1 <= k <= HAMMING_TOPK_CAP. Returns (scores [Q, k'] f32
    = -distance, ids [Q, k'] int32), k' = min(k, N): the k' best rows by
    (distance ascending, row ascending), -inf / -1 past the live rows.
    The kernel writes each (row group, row slice)'s k best keys; one
    ``torch.topk`` over [Q, groups * slices * k] finishes the job, as
    ``lax.top_k`` sits outside the Pallas kernel. Rows too wide for the
    kernel's stages (no plan fits shared memory: about 1,390 words at k
    64) take ``hamming_scores`` and the same keyed merge."""
    _check_hamming(corpus_bits, query_bits)
    dev = corpus_bits.device
    (n, w), q = corpus_bits.shape, query_bits.shape[0]
    if mask is not None:
        _check("mask", mask, torch.bool, 1, dev)
        if mask.shape[0] != n:
            raise ValueError(f"mask {tuple(mask.shape)} for {n} rows")
    if not 1 <= k <= HAMMING_TOPK_CAP:
        raise ValueError(f"hamming_topk takes 1 <= k <= {HAMMING_TOPK_CAP} "
                         f"(k={k})")
    if dev.type == "cpu":
        return hamming_topk_plain(corpus_bits, query_bits, mask, k)
    _hamming_cuda_ready("hamming_topk", corpus_bits, query_bits)
    if mask is not None and not mask.is_contiguous():
        raise ValueError("mask must be contiguous for the kernel")
    if mask is not None and mask.data_ptr() % 4:   # read 4 bytes at a time
        mask = mask.clone()
    if not (q and n):
        return (torch.full((q, min(k, n)), float("-inf"), device=dev),
                torch.full((q, min(k, n)), -1, dtype=torch.int32, device=dev))
    plan = _hamming_groups(
        n, q, w, k, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    if plan is None:   # rows too wide for a stage: the distances kernel
        best = None
        for r0 in range(0, n, _HT_WIDE_BLOCK):
            best = merge_keys(best, hamming_keys(hamming_scores(
                corpus_bits[r0:r0 + _HT_WIDE_BLOCK], query_bits), r0, mask),
                min(k, n))
        return decode_hamming_keys(best)
    if -(-q // (_HT_TILE * plan[0])) > 65535:   # query blocks on grid.y
        raise ValueError(f"hamming_topk kernel needs Q <= "
                         f"{65535 * _HT_TILE * plan[0]} (Q={q})")
    out = torch.empty((q, plan[4] * plan[1] * k), dtype=torch.int64,
                      device=dev)
    gthr = torch.empty(q, dtype=torch.int64, device=dev)
    _hamming_topk_launch(corpus_bits, query_bits, mask, k, plan, out, gthr)
    LAUNCHES["hamming_topk"] += 1
    return decode_hamming_keys(merge_keys(None, out, min(k, n)))


# ---------------------------------------------------------------------------
# kernel 8: PQ ADC scan, the top-k inside (select) or the scores written
# ---------------------------------------------------------------------------

# the select mode's largest k (it keeps k keys a query in shared memory,
# as row 7 does); callers take pq_adc_scores and a selection above it
PQ_ADC_TOPK_CAP = 64
# csrc/pq_adc.cu's geometry: the lane layout's columns a pass and table
# chunk; the shared layout's queries a block, table copies, rows a pass
# and stages of its ring (a subspace each) in select and scores mode; a
# query's candidate buffer; a block's shared memory
_PQ_LANE_PASS = 2048
_PQ_LANE_CHUNK = 48
_PQ_QB = 8
_PQ_COPIES = 4
_PQ_SHARED_PASS = 4096
_PQ_STAGES = {True: 3, False: 6}
_PQ_CAP = 192
_PQ_SMEM = 232448
# the fewest queries of a full scan the shared layout takes: on an H100
# (scripts/torch_pq_adc_probe.py, 2^20 rows x M 96) the lane layout took
# 0.317 ms at Q 4 against 0.471, the shared one 0.478 at Q 8 against 0.540
_PQ_SHARED_MIN_Q = 8
# lane-layout blocks a SM that a select launch's grid fills
_PQ_LANE_BLOCKS_PER_SM = 4


def _check_pq_adc(codes, tables, valid, cand):
    dev = codes.device
    _check("codes", codes, torch.uint8, 2, dev)
    _check("tables", tables, torch.float32, 3, dev)
    _check("valid", valid, torch.bool, 1, dev)
    n, m = codes.shape
    q = tables.shape[0]
    if tables.shape[1:] != (m, 256) or valid.shape[0] != n or (
            cand is not None and (cand.dtype != torch.int32
                                  or cand.ndim != 2 or cand.shape[0] != q
                                  or cand.device != dev)):
        raise ValueError(
            f"pq_adc shapes: codes {tuple(codes.shape)}, tables "
            f"{tuple(tables.shape)} (want [Q, M, 256]), valid "
            f"{tuple(valid.shape)}, cand "
            f"{None if cand is None else (tuple(cand.shape), cand.dtype)}"
            f" (want [Q, C] int32)")


def pq_adc_scores_plain(codes, tables, valid, cand=None):
    """Plain PyTorch version of ``pq_adc_scores``, bit-identical to it:
    each score is the f32 sum of the looked-up table values in subspace
    order m = 0 .. M-1, negated; -inf for dead rows and -1 candidates.
    Steps of rows (or candidates) bound the [Q, step] temporaries."""
    n, m = codes.shape
    q = tables.shape[0]
    cols = n if cand is None else cand.shape[1]
    out = torch.empty((q, cols), dtype=torch.float32, device=codes.device)
    for c0, c1 in _row_steps(cols, q):
        if cand is None:
            rows = torch.arange(c0, c1, device=codes.device)[None, :]
        else:
            rows = cand[:, c0:c1].long()
        live = (rows >= 0) & (rows < n)
        rows = torch.where(live, rows, torch.zeros_like(rows))
        live &= valid[rows]
        acc = torch.zeros((q, c1 - c0), dtype=torch.float32,
                          device=codes.device)
        for j in range(m):
            code = codes[rows, j].long().expand(q, -1)
            acc = acc + torch.gather(tables[:, j, :], 1, code)
        out[:, c0:c1] = torch.where(live, -acc,
                                    torch.full_like(acc, float("-inf")))
    return out


def pq_adc_topk_plain(codes, tables, valid, k: int, cand=None):
    """Plain PyTorch version of ``pq_adc_topk``: ``_topk_stable`` of
    ``pq_adc_scores_plain``'s scores, taken in steps of columns whose
    keys are merged (the keys are distinct, so the steps change
    nothing), decoded as the kernel's keys are."""
    n = codes.shape[0]
    q = tables.shape[0]
    cols = n if cand is None else cand.shape[1]
    kk = min(k, cols)
    best = torch.empty((q, 0), dtype=torch.int64, device=codes.device)
    for c0, c1 in _row_steps(cols, q):
        if cand is None:
            s = pq_adc_scores_plain(codes[c0:c1], tables, valid[c0:c1])
        else:
            s = pq_adc_scores_plain(codes, tables, valid, cand[:, c0:c1])
        best = merge_keys(best, stable_keys(s, c0), kk, largest=True)
    return decode_score_keys(best)


def _pq_smem(shared: bool, chunk: int, k: int, select: bool) -> int:
    """Shared-memory bytes of one block (csrc/pq_adc.cu ``layout``): the
    tables (shared: each stage of the ring [256, 4 copies, 8 queries];
    lane: [chunk, 256]), the codes (shared: each stage's 4,096 bytes),
    in select mode each query's best keys, candidate buffer, limit, k-th
    key and count, and (shared) each stage's two mbarriers."""
    if shared:
        b = _PQ_STAGES[select] * (256 * _PQ_QB * _PQ_COPIES * 4
                                  + _PQ_SHARED_PASS)
    else:
        b = chunk * 256 * 4
    if select:
        b += (_PQ_QB if shared else 1) * ((k + _PQ_CAP) * 8 + 20)
    b = -(-b // 8) * 8
    return b + (2 * _PQ_STAGES[select] * 8 if shared else 0)


def _pq_adc_plan(cols: int, q: int, m: int, k: int, gathered: bool,
                 select: bool, sms: int):
    """The ADC kernel's plan: (shared, chunk, parts, span).

    ``shared``: the full scan at ``_PQ_SHARED_MIN_Q`` queries or more
    takes the shared layout (8 queries a block, passes of 4,096 rows);
    fewer queries and the gathered mode the lane layout (a query a
    block, passes of 2,048 columns). ``chunk``: subspaces a table chunk
    (shared: 1, a stage of its ring; lane: up to 48).
    Each block walks ``span`` columns (whole passes) of its query or
    query group; ``parts`` blocks cover the columns. Shared: at least
    enough parts to fill the SMs, then the count of parts (up to one a
    pass) whose waves of one block a SM times a block's passes and
    set-up is least. Lane: select mode fills _PQ_LANE_BLOCKS_PER_SM
    blocks a SM with as few parts as that takes (a block's first pass
    merges the most keys), scores mode a block a pass."""
    shared = not gathered and q >= _PQ_SHARED_MIN_Q
    if shared:
        chunk = 1
        groups = -(-q // _PQ_QB)
        passes = -(-cols // _PQ_SHARED_PASS)
        low = min(passes, -(-sms // groups))
        # a block's set-up and first merges cost about (32 + 2 k) / 128 of
        # a pass (at Q 1,024 x 2^20 x M 96, k 10: 27.6 ms in 2 parts, 29.1
        # in 8, 31.6 in 128; scripts/torch_pq_adc_probe.py)
        parts = min(range(low, min(passes, 4 * low + sms) + 1),
                    key=lambda p: (-(-p * groups // sms)
                                   * (128 * -(-passes // p) + 32 + 2 * k),
                                   p))
        span = -(-passes // parts) * _PQ_SHARED_PASS
    else:
        chunk = min(_PQ_LANE_CHUNK, m)
        tiles = -(-cols // _PQ_LANE_PASS)
        parts = tiles
        if select:
            parts = min(tiles, -(-_PQ_LANE_BLOCKS_PER_SM * sms // q))
        span = -(-tiles // parts) * _PQ_LANE_PASS
    return shared, chunk, -(-cols // span), span


def _pq_adc_launch(codes, tables, valid, cand, k: int, select: bool):
    """One launch of the ADC kernel by its plan: (keys [Q, parts * k]
    int64, each block's k greatest keys a query) in select mode, else
    the scores [Q, C] f32. Raises on a CUDA error."""
    dev = codes.device
    n, m = codes.shape
    q = tables.shape[0]
    cols = n if cand is None else cand.shape[1]
    if q > 65535:
        raise ValueError(f"pq_adc kernel takes Q <= 65535 a call (Q={q})")
    if cols >= (1 << 32) - 1:
        raise ValueError(f"pq_adc kernel takes fewer than 2^32 - 1 columns "
                         f"({cols})")
    for name, t in (("codes", codes), ("tables", tables), ("valid", valid),
                    *((("cand", cand),) if cand is not None else ())):
        _launch_ready(name, t)
    shared, chunk, parts, span = _pq_adc_plan(
        cols, q, m, k, cand is not None, select,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    npad = parts * span if shared else 0
    codes_t = (torch.empty((m, npad), dtype=torch.uint8, device=dev)
               if shared else None)
    tables_g = (torch.empty((-(-q // _PQ_QB), m, 256, _PQ_QB),
                            dtype=torch.float32, device=dev)
                if shared else None)
    ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
    lib = build_kernels()
    head = (codes.data_ptr(), tables.data_ptr(), valid.data_ptr(), ptr(cand))
    if select:
        out = torch.empty((q, parts * k), dtype=torch.int64, device=dev)
        gthr = torch.empty(q, dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = lib.neumann_pq_adc_select(
                *head, out.data_ptr(), gthr.data_ptr(), ptr(codes_t),
                ptr(tables_g), n, cols, q, m, k, int(shared), chunk, parts,
                span, npad, _stream())
    else:
        out = torch.empty((q, cols), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.neumann_pq_adc_scores(
                *head, out.data_ptr(), ptr(codes_t), ptr(tables_g), n, cols,
                q, m, int(shared), chunk, parts, span, npad, _stream())
    _raise_on(err, "pq_adc")
    return out


def pq_adc_scores(codes, tables, valid, cand=None):
    """ADC scores [Q, C] f32: ``-sum_m tables[q, m, codes[row, m]]`` for
    the row of each column, -inf where the row is dead (``valid``
    False) or the candidate is -1 (the kernel's scores mode).

    codes [N, M] uint8, tables [Q, M, 256] f32 (squared distances of each
    query's subvectors to the 256 centroids of each subspace), valid [N]
    bool. ``cand`` None: the full scan, C = N, column c is row c; else
    cand [Q, C] int32 row ids, each query scoring its own candidates (the
    gathered mode of IVFIndex's pq storage). Q is at most 65,535 a call:
    callers step queries to bound the [Q, C] output."""
    _check_pq_adc(codes, tables, valid, cand)
    dev = codes.device
    n = codes.shape[0]
    q = tables.shape[0]
    cols = n if cand is None else cand.shape[1]
    if dev.type == "cpu":
        return pq_adc_scores_plain(codes, tables, valid, cand)
    if dev.type != "cuda":
        raise ValueError(f"pq_adc_scores: unsupported device {dev}")
    if not (q and cols):
        return torch.empty((q, cols), dtype=torch.float32, device=dev)
    out = _pq_adc_launch(codes, tables, valid, cand, 0, False)
    LAUNCHES["pq_adc"] += 1
    return out


def pq_adc_topk(codes, tables, valid, k: int, cand=None):
    """The k best columns of the ADC scores in one launch, no [Q, C]
    scores in device memory (the JAX package's ``_adc_search_fn``, the
    sums and ``lax.top_k`` in one function).

    Arguments as ``pq_adc_scores``, 1 <= k <= PQ_ADC_TOPK_CAP. Returns
    (scores [Q, k'] f32, columns [Q, k'] int64), k' = min(k, C), equal
    to ``_topk_stable(pq_adc_scores(...), k')``: descending, equal scores
    by ascending column (rows with equal codes by ascending row; in the
    gathered mode candidates by probe order), -inf past the live rows
    (their columns are those of dead rows or -1 candidates, which
    callers mask). The kernel writes each block's k' best keys a query;
    one ``torch.topk`` over [Q, parts * k'] finishes."""
    _check_pq_adc(codes, tables, valid, cand)
    if not 1 <= k <= PQ_ADC_TOPK_CAP:
        raise ValueError(f"pq_adc_topk takes 1 <= k <= {PQ_ADC_TOPK_CAP} "
                         f"(k={k})")
    dev = codes.device
    n = codes.shape[0]
    q = tables.shape[0]
    cols = n if cand is None else cand.shape[1]
    if dev.type == "cpu":
        return pq_adc_topk_plain(codes, tables, valid, k, cand)
    if dev.type != "cuda":
        raise ValueError(f"pq_adc_topk: unsupported device {dev}")
    kk = min(k, cols)
    if not (q and cols):
        return (torch.empty((q, kk), dtype=torch.float32, device=dev),
                torch.empty((q, kk), dtype=torch.int64, device=dev))
    keys = _pq_adc_launch(codes, tables, valid, cand, kk, True)
    LAUNCHES["pq_adc_select"] += 1
    return decode_score_keys(merge_keys(None, keys, kk, largest=True))


# ---------------------------------------------------------------------------
# kernel 9: the exact int8 scan (the IVF delta plane), the top-k inside
# (select) or the scores written
# ---------------------------------------------------------------------------

# the select mode's largest k (it keeps k keys a query in shared memory);
# above it the scores mode and a selection with a carry
INT8_EXACT_TOPK_CAP = 64
# bytes one step of int8_exact_topk_plain or of the scores mode may hold:
# its block of rows converted to f32, or its [Q, block] scores
_EXACT_STEP_BYTES = 256 << 20
# csrc/int8_exact.cu's geometry: the queries' row stride divides by
# _EXACT_LDQ (the stream kernel's K bytes a stage); the stream kernel takes
# up to _EXACT_STREAM_Q queries (slots of 1, 4 or 16) in tiles of 256 rows,
# the batch kernel tiles of 128 rows x 128 queries. A select block's shared
# memory: the stream kernel's three stages [256 rows x 64 bytes][slots x 64
# floats] and 128 buffered keys a slot, or the batch kernel's four tiles of
# 32 x 132 floats and 32 buffered keys a query; each slot's k keys, k-th
# key and count. A SM holds _SM_SMEM bytes, 1,024 of them reserved a
# block, and at most two blocks of either kernel
_EXACT_LDQ = 64
_EXACT_STREAM_Q = 16
_EXACT_STREAM_ROWS = 256
_EXACT_BATCH = 128
_SM_SMEM = 233472


def _exact_plan(n: int, q: int, k: int, select: bool, sms: int):
    """The exact scan's plan: (parts, span). Each of ``parts`` blocks (a
    query block's) walks ``span`` rows, whole tiles. Scores mode: a tile
    a block. Select mode: one wave of the blocks a SM holds by shared
    memory (two up to k 13 in the batch kernel, one above: two waves of
    more, shorter parts ran slower on an H100, each part merging its
    first tiles' keys), each writing k keys a query."""
    stream = q <= _EXACT_STREAM_Q
    tile = _EXACT_STREAM_ROWS if stream else _EXACT_BATCH
    tiles = -(-n // tile)
    if not select:
        return tiles, tile
    if stream:
        slots = 1 if q <= 1 else (4 if q <= 4 else 16)
        smem = (3 * (_EXACT_STREAM_ROWS + slots * 4) * _EXACT_LDQ
                + slots * ((k + 129) * 8 + 4))
        qblocks = 1
    else:
        smem = 4 * 32 * 132 * 4 + _EXACT_BATCH * ((k + 33) * 8 + 4)
        qblocks = -(-q // _EXACT_BATCH)
    per_sm = max(1, min(2, _SM_SMEM // (smem + 1024)))
    parts = max(1, min(tiles, sms * per_sm // qblocks))
    span = -(-tiles // parts) * tile
    return -(-n // span), span


def _exact_carry(best_s, best_i, s, k: int, r0: int):
    """The exact scan's running top-k over a block of scores ``s`` of
    rows r0 ..: the carry's rows all precede the block's, so a stable
    cut over [carry, block] orders equal scores by row."""
    best_s, col = _topk_stable(torch.cat([best_s, s], dim=1), k)
    best_i = torch.where(col < k, best_i.gather(1, col.clamp(max=k - 1)),
                         col - k + r0)
    return best_s, best_i


def _exact_block(n: int, d: int, q: int, block_rows: int) -> int:
    return max(1, min(block_rows, _EXACT_STEP_BYTES // (4 * max(d, q))))


def int8_exact_topk_plain(corpus_q, row_mult, qf, k: int,
                          block_rows: int = 256 * 1024):
    """Plain PyTorch version of ``int8_exact_topk``: each block of rows
    converted to f32 and multiplied by ``torch.matmul`` (TF32 off: the
    package docstring), as the JAX package multiplies at
    ``Precision.HIGHEST``; a running top-k carries across blocks in
    ``lax.top_k``'s order, equal scores by ascending row. A block holds
    at most ``block_rows`` rows, and fewer where its f32 rows or its
    scores would pass ``_EXACT_STEP_BYTES``."""
    n, d = corpus_q.shape
    k = min(k, n)
    q = qf.shape[0]
    block = _exact_block(n, d, q, block_rows)
    best_s = qf.new_full((q, k), float("-inf"))
    best_i = torch.full((q, k), -1, dtype=torch.int64, device=qf.device)
    for r0 in range(0, n, block):
        rm = row_mult[r0:r0 + block]
        s = qf @ corpus_q[r0:r0 + block].float().T
        s = torch.where(rm > 0, s * rm, torch.full_like(s, float("-inf")))
        best_s, best_i = _exact_carry(best_s, best_i, s, k, r0)
    return best_s, best_i.masked_fill(torch.isneginf(best_s), -1)


def _exact_queries(qf):
    """The kernel's queries: [Q, ldq] f32, zero past d, ldq the least
    multiple of _EXACT_LDQ >= d (qf itself where it is that already)."""
    q, d = qf.shape
    ldq = -(-d // _EXACT_LDQ) * _EXACT_LDQ
    if ldq == d and qf.is_contiguous() and qf.data_ptr() % 16 == 0:
        return qf
    x = qf.new_zeros((q, ldq))
    x[:, :d] = qf
    return x


def _exact_launch(corpus_q, row_mult, x, k: int, select: bool):
    """One launch of the exact scan by its plan: (keys [Q, parts * k]
    int64, each block's k greatest keys a query) in select mode, else
    the masked scores [Q, N] f32. Raises on a CUDA error."""
    dev = corpus_q.device
    n, d = corpus_q.shape
    q = x.shape[0]
    if n >= (1 << 32) - 1:
        raise ValueError(f"int8_exact kernel takes fewer than 2^32 - 1 rows "
                         f"a launch ({n})")
    parts, span = _exact_plan(
        n, q, k, select,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = build_kernels()
    head = (corpus_q.data_ptr(), row_mult.data_ptr(), x.data_ptr())
    if select:
        out = torch.empty((q, parts * k), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = lib.neumann_int8_exact_select(
                *head, out.data_ptr(), n, d, x.shape[1], q, k, parts, span,
                _stream())
    else:
        out = torch.empty((q, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.neumann_int8_exact_scores(
                *head, out.data_ptr(), n, d, x.shape[1], q, parts, span,
                _stream())
    _raise_on(err, "int8_exact")
    return out


def int8_exact_topk(corpus_q, row_mult, qf, k: int,
                    block_rows: int = 256 * 1024):
    """Exact cosine top-k over an int8 corpus with f32 queries and f32
    math throughout (the JAX package's ``int8_exact_topk`` after its
    query normalisation: ``ops/quant.int8_exact_topk`` normalises).

    corpus_q [N, d] int8, row_mult [N] f32 (``int8_cosine_row_mult``; 0
    marks invalid rows), qf [Q, d] f32 unit queries. Score = (qf .
    float(row)) * row_mult, -inf where row_mult <= 0. Returns (scores
    [Q, k'] f32, rows [Q, k'] int64, -1 where -inf), k' = min(k, N),
    descending, equal scores by ascending row (``lax.top_k``'s order).

    On the card, k' <= INT8_EXACT_TOPK_CAP: one select launch (each
    block's k' best keys a query; one ``torch.topk`` over them
    finishes); above it, the scores mode a block of rows (``block_rows``,
    bounded by _EXACT_STEP_BYTES) and ``_topk_stable`` with the carry.
    ``block_rows`` steps only the plain version and the scores mode; the
    kernel's results do not depend on it."""
    dev = corpus_q.device
    _check("corpus_q", corpus_q, torch.int8, 2, dev)
    _check("row_mult", row_mult, torch.float32, 1, dev)
    _check("qf", qf, torch.float32, 2, dev)
    n, d = corpus_q.shape
    q = qf.shape[0]
    if qf.shape[1] != d or row_mult.shape[0] != n:
        raise ValueError(f"int8_exact shapes: corpus {tuple(corpus_q.shape)},"
                         f" row_mult {tuple(row_mult.shape)}, queries "
                         f"{tuple(qf.shape)}")
    if dev.type == "cpu":
        return int8_exact_topk_plain(corpus_q, row_mult, qf, k, block_rows)
    if dev.type != "cuda":
        raise ValueError(f"int8_exact_topk: unsupported device {dev}")
    kk = min(k, n)
    if not q or kk < 1:
        return (torch.empty((q, max(kk, 0)), dtype=torch.float32, device=dev),
                torch.empty((q, max(kk, 0)), dtype=torch.int64, device=dev))
    for name, t in (("corpus_q", corpus_q), ("row_mult", row_mult)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    x = _exact_queries(qf)
    if kk <= INT8_EXACT_TOPK_CAP:
        keys = _exact_launch(corpus_q, row_mult, x, kk, True)
        LAUNCHES["int8_exact_select"] += 1
        best_s, best_i = decode_score_keys(merge_keys(None, keys, kk,
                                                      largest=True))
        return best_s, best_i.masked_fill(torch.isneginf(best_s), -1)
    best_s = qf.new_full((q, kk), float("-inf"))
    best_i = torch.full((q, kk), -1, dtype=torch.int64, device=dev)
    block = _exact_block(n, d, q, block_rows)
    for r0 in range(0, n, block):
        s = _exact_launch(corpus_q[r0:r0 + block], row_mult[r0:r0 + block],
                          x, 0, False)
        LAUNCHES["int8_exact_scores"] += 1
        best_s, best_i = _exact_carry(best_s, best_i, s, kk, r0)
    return best_s, best_i.masked_fill(torch.isneginf(best_s), -1)
