"""neumann_tpu_torch — the PyTorch + CUDA port of neumann_tpu.

The JAX package (``neumann_tpu``) is the reference; this package mirrors
its layout (``ops/``, ``store/``, ``engines/``, ``router/``, ``lang/``,
``parallel/``, ``csrc/``) so each module's counterpart is easy to find.
It imports ``torch`` and never ``jax``. It reuses the reference's
JAX-free leaves by import (``neumann_tpu.store.tensor_store``,
``store.entity_index``, ``store.embedding_slab``, ``utils.*``,
``native``).

What runs here today is the auto-IVF ``SIMILAR … TOP k`` path: the
query language, the vector engine's storage and search surface, the
exact scan, the int8 windowed IVF index, and the two CUDA kernels it
runs (``csrc/ivf_probe.cu``, ``csrc/batched_probe.cu``).

TF32 is switched off for float32 matrix products: the IVF build assigns
rows to windows by an f32 argmax whose margins are correctness-coupled
(a row must land in the window the f32 query-side probe ranks first;
see ``neumann_tpu/ops/ivf.py`` build), and the exact scan is the recall
oracle. TF32 keeps about three decimal digits, which is not enough for
either.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
