"""The port imports and runs on a machine without JAX, and (on a card)
its CUDA kernels agree with their plain PyTorch versions.

The first test runs in a subprocess where ``import jax`` fails, imports
every module of neumann_tpu_torch, and drives a tiny SIMILAR through
the router on the CPU. The ``cuda`` tests need an NVIDIA card with
``nvcc`` (the kernels build from csrc/ at first use); they skip
elsewhere. Run them on the card with
``python -m pytest tests/test_torch_nojax.py -m cuda``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_NOJAX = textwrap.dedent("""
    import sys
    for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
        del sys.modules[name]           # e.g. pre-imported by a site hook
    sys.modules["jax"] = None           # any `import jax` now fails
    import importlib, pkgutil
    import numpy as np
    import neumann_tpu_torch
    for m in pkgutil.walk_packages(neumann_tpu_torch.__path__,
                                   "neumann_tpu_torch."):
        importlib.import_module(m.name)
    from neumann_tpu_torch.router import QueryRouter
    from neumann_tpu_torch.lang import parse
    parse("SELECT a + 1 FROM t WHERE b > 2")
    r = QueryRouter(device="cpu")
    v = np.random.default_rng(0).standard_normal((20, 8))
    for i in range(20):
        r.execute(f"EMBED STORE 'k{i}' [{', '.join(map(str, v[i]))}]")
    hits = r.execute(f"SIMILAR [{', '.join(map(str, v[4]))}] TOP 3").results
    assert hits[0]["key"] == "k4", hits
    bad = [m for m, mod in sys.modules.items()
           if mod is not None and (m == "jax" or m.startswith("jax.")
               or m.startswith(("neumann_tpu.ops", "neumann_tpu.engines",
                                "neumann_tpu.lang", "neumann_tpu.router")))]
    assert not bad, bad
    print("OK")
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _NOJAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_source_has_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    srcs = list((ROOT / "neumann_tpu_torch").rglob("*.py"))
    assert srcs
    assert not [p for p in srcs if pat.search(p.read_text())]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernel_matches_plain(cuda):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(0)
    n, d, window, q, nprobe = 64 * 1024, 768, 1024, 4, 8
    buf = torch.randint(-127, 128, (n, d), generator=g, device=cuda,
                        dtype=torch.int8)
    rm = torch.rand(n, generator=g, device=cuda) * 1e-3
    rm[::37] = 0.0
    sb = torch.randint(0, n // 128 - window // 128 + 1, (q, nprobe),
                       generator=g, device=cuda, dtype=torch.int32)
    qs = torch.randn(q, d, generator=g, device=cuda)
    qs /= qs.norm(dim=1, keepdim=True)
    before = tk.LAUNCHES["ivf_probe"]
    got = tk.ivf_probe_scores(buf, rm, sb, qs, window)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ivf_probe"] == before + 1
    want = tk.ivf_probe_scores_plain(buf, rm, sb, qs, window)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("top2", [False, True])
def test_batched_kernel_bit_exact(cuda, top2):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(1)
    n_win, q_cap, d, window = 64, 40, 768, 1024
    buf = torch.randint(-127, 128, (n_win * window, d), generator=g,
                        device=cuda, dtype=torch.int8)
    qsel = torch.randint(-127, 128, (n_win, q_cap, d), generator=g,
                         device=cuda, dtype=torch.int8)
    rm = torch.rand(n_win, window, generator=g, device=cuda) * 1e-3
    rm[:, ::41] = 0.0
    scm = torch.rand(n_win, q_cap, generator=g, device=cuda) * 1e-2
    scm[:, 20:] = 0.0                          # empty slots / tiles
    got = tk.batched_probe(buf, rm, qsel, scm, window, top2=top2)
    torch.cuda.synchronize()
    want = tk.batched_probe_plain(buf, rm, qsel, scm, window, top2=top2)
    assert torch.equal(got, want)
