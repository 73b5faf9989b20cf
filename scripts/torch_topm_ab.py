#!/usr/bin/env python3
"""Time row 10 (``kernels.ivf_window_topm``, ``csrc/ivf_topm.cu``) of two
trees in turns on one NVIDIA card, at ``chip_smoke.py``'s five row-10
shapes (A17's TOP 65 batch and ``TOPM_EDGES``).

Usage, from the root of a checkout::

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python scripts/torch_topm_ab.py --other build/parent [--seed 0]
        [--stream-only]

The other tree's ``neumann_tpu_torch/ops/kernels.py`` is loaded by path
under another module name, so its wrapper builds and launches its own
``csrc/`` into its own ``build/``. At each shape (``chip_smoke.
topm_cases``, the same inputs for both) the turns are other, this,
this, other: the call's mean ms by CUDA events and the kernel's device
ms from torch.profiler, and both trees' outputs must equal this tree's
plain version bit for bit on every filled slot. ``--stream-only`` also
builds this tree's source with ``NEUMANN_TOPM_STREAM_ONLY`` (the kernel
without its selection: the rows streamed, the products and the scores'
images stored, nothing written) and times it beside them: the share of
the kernel's time that its selection adds. Writes
chiprun_out/topm_ab.json and prints it as one JSON line, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import threading
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def kernels_module(path: str, name: str, flags=(), build_dir=None):
    """A kernels.py loaded by path as module ``name``: its own library,
    built from the sources beside it (with extra nvcc ``flags`` into
    ``build_dir``, where given)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    if flags:
        mod.NVCC_FLAGS = (*mod.NVCC_FLAGS, *flags)
    if build_dir is not None:
        mod.BUILD_DIR = Path(build_dir)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout whose row 10 is timed "
                         "beside this one's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-only", action="store_true",
                    help="also time this tree's kernel without its "
                         "selection")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_topm_ab: no CUDA device", file=sys.stderr)
        return 2
    import neumann_tpu_torch  # noqa: F401  (sets TF32 off)
    from neumann_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    mods = {"this": tk, "other": kernels_module(
        os.path.join(args.other, "neumann_tpu_torch", "ops", "kernels.py"),
        "neumann_other_kernels")}
    if args.stream_only:
        mods["stream_only"] = kernels_module(
            tk.__file__, "neumann_stream_only_kernels",
            ("-DNEUMANN_TOPM_STREAM_ONLY",),
            os.path.join(HERE, "build", "topm_stream_only"))
    builds = [threading.Thread(target=m.build_kernels) for m in mods.values()]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
    for tag, m in mods.items():
        m.build_kernels()      # raises here if its build failed
    out = dict(card=cs.smi_line(), other=args.other, shapes={})
    order = ("other", "this", "this", "other")
    for sfx, a, filled, window, m, q in cs.topm_cases(dev, args.seed):
        reps = 5 if q > 64 else 20
        want = tk.ivf_window_topm_plain(*a, window, m)
        on = (a[4] >= 0)[:, :, None].expand_as(want[0])
        rec = dict(filled_slots=filled, window=window, m=m,
                   windows=a[4].shape[0], d=a[0].shape[1])
        for tag in ("this", "other"):
            got = mods[tag].ivf_window_topm(*a, window, m)
            rec[f"{tag}_bits_differ"] = int(
                (got[0][on].view(torch.int32)
                 != want[0][on].view(torch.int32)).sum()
                + (got[1][on] != want[1][on]).sum())
            del got
        del want, on
        for tag in order + (("stream_only",) if args.stream_only else ()):
            fn = (lambda k=mods[tag]: k.ivf_window_topm(*a, window, m))
            rec.setdefault(f"{tag}_ms", []).append(cs.cuda_ms(fn, reps))
            rec.setdefault(f"{tag}_device_ms", []).append(cs.device_ms(
                fn, 3, "ivf_topm", only=r"ivf_topm_kernel"))
        name = sfx[1:] or "a17"
        out["shapes"][name] = rec
        cs.say(f"[topm_ab] {name}: this {rec['this_ms']} ms (device "
               f"{rec['this_device_ms']}), other {rec['other_ms']} ms "
               f"(device {rec['other_device_ms']})"
               + (f", stream only {rec['stream_only_ms']} ms"
                  if args.stream_only else ""))
        if rec["this_bits_differ"] or rec["other_bits_differ"]:
            raise AssertionError(f"row 10 departs from its plain version "
                                 f"at {name}: {rec}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "topm_ab.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
