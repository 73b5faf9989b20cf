"""neumann_tpu_torch — the PyTorch + CUDA port of neumann_tpu.

The JAX package (``neumann_tpu``) is the reference; this package mirrors
its layout (``ops/``, ``store/``, ``engines/``, ``router/``, ``lang/``,
``parallel/``, ``csrc/``) so each module's counterpart is easy to find.
It imports ``torch`` and never ``jax``, and nothing of the JAX package:
the modules it needs that are free of JAX (the host store, the entity
index, the codec, WAL and snapshots, the error types, the native
loaders and their C++ sources) are the port's own copies, in the same
places (``store/``, ``utils/``, ``native/``).

What runs here today: the query language; the relational, graph and
unified engines (SQL, graph statements and analytics, Cypher, the
hybrid ``SIMILAR … CONNECTED TO`` / FIND queries); the vector engine's
storage, namespaces and collections (f32, int8 and binary), the exact
scan, the brute-force pooled routes, the int8 windowed IVF index, and
the CUDA kernels they run (``csrc/``, built at first use;
``ops/kernels.py``); the extended modules (checkpoints, blobs, the LLM
cache, the vault) and the chain and cluster (``chain/``: chain
transactions, Raft, 2PC, gossip, cluster nodes whose routers run on the
card).

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
