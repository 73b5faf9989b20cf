"""k-means for the IVF build (the slice's part of
``neumann_tpu/parallel/partitioner.py``).

``kmeans``: the JAX package's numpy k-means++ seeding, then Lloyd steps
in numpy below a size threshold and in torch above it (``segment_sum``
becomes ``index_add_``). From the same seed both packages start from
the same centroids.

``kmeans_device``: Lloyd's over a device-resident sample with random
distinct-row init drawn from an explicit ``torch.Generator`` and FAISS
style balance reseeding. ``jax.random`` and ``torch.Generator`` give
different numbers from one seed, so the two packages' device k-means
start from different rows by construction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# below this many elements numpy Lloyd's beats a device round trip
_DEVICE_KMEANS_MIN_ELEMS = 262_144


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def kmeans(vectors, k: int, iters: int = 20, seed: int = 0, *,
           device) -> np.ndarray:
    """K-means (Lloyd's), k-means++ seeded on a bounded subsample (the
    draws on the host, the distance updates in float64 on ``device`` at
    scale); torch Lloyd steps on ``device`` at scale, pure numpy below
    the threshold. ``vectors`` is a numpy array or a tensor (a tensor on
    ``device`` stays there: only the seeding subsample, or the whole of
    a small input, comes to the host). ``device`` has no default: the
    caller names where the steps run. Returns host centroids [k, d]
    f32."""
    n, d = vectors.shape
    k = min(k, n)
    rng = np.random.default_rng(seed)
    seed_rows = min(n, max(4 * k, 16_384))
    seed_idx = (np.arange(n) if seed_rows >= n
                else rng.choice(n, seed_rows, replace=False))
    x_seed = _host(vectors[torch.from_numpy(seed_idx)]
                   if torch.is_tensor(vectors) else vectors[seed_idx])
    x64 = x_seed.astype(np.float64)
    if n * d < _DEVICE_KMEANS_MIN_ELEMS:
        def dist2(c):
            return np.sum((x64 - x64[c]) ** 2, axis=1)
    else:
        # the seeding's k sequential passes over the subsample, in float64
        # on the device (a host pass over 16,384 x 768 takes tens of ms)
        xs = torch.from_numpy(x64).to(device)

        def dist2(c):
            return ((xs - xs[c]) ** 2).sum(1).cpu().numpy()
    first = rng.integers(seed_rows)
    chosen = [first]
    d2 = dist2(first)
    for _ in range(1, k):
        total = d2.sum()
        if total <= 0:
            chosen.append(rng.integers(seed_rows))
        else:
            chosen.append(int(rng.choice(seed_rows, p=d2 / total)))
        d2 = np.minimum(d2, dist2(chosen[-1]))
    centroids = x_seed[chosen].astype(np.float32)

    if n * d < _DEVICE_KMEANS_MIN_ELEMS:
        x = _host(vectors).astype(np.float32)
        cent = centroids.astype(np.float32)
        for _ in range(iters):
            d2 = (np.sum(x * x, 1, keepdims=True)
                  - 2.0 * x @ cent.T + np.sum(cent * cent, 1)[None, :])
            assign = np.argmin(d2, axis=1)
            for c in range(k):
                members = x[assign == c]
                if len(members):
                    cent[c] = members.mean(axis=0)
        return cent

    x = (vectors.to(device, torch.float32) if torch.is_tensor(vectors)
         else torch.as_tensor(np.asarray(vectors, np.float32),
                              device=device))
    cent = torch.as_tensor(np.asarray(centroids, np.float32), device=device)
    for _ in range(iters):
        d2 = ((x * x).sum(1, keepdim=True) - 2.0 * x @ cent.T
              + (cent * cent).sum(1)[None, :])
        assign = d2.argmin(dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k).float()
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp_min(1.0)[:, None], cent)
    return cent.cpu().numpy()


def kmeans_device(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0,
                  balance: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Lloyd's over a device-resident sample [n, d]; returns centroids
    [k, d] f32 on x's device.

    Random distinct-row init from ``generator`` (a fresh one seeded with
    ``seed`` on x's device when None). balance: between Lloyd steps the
    i-th most starved cluster adopts a jittered copy of the i-th fattest
    one's centroid when it holds < 1/2 of a fair share and the donor
    > 3/2 (jitter 0.3x the donor's RMS radius); the last two iterations
    never reseed, so the result is a plain Lloyd fixed point of its last
    assignment. Assignment scores use bf16-rounded inputs with f32
    accumulation, as the JAX package does; the centroid update is
    exact f32."""
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
    n = x.shape[0]
    k = min(k, n)
    x = x.float()
    idx = torch.randperm(n, generator=generator, device=x.device)[:k]
    cent = x[idx]
    fair = n / k
    xx = (x * x).sum(1)
    xb = x.to(torch.bfloat16).float()
    for i in range(iters):
        score = xb @ cent.to(torch.bfloat16).float().T
        assign = (score - 0.5 * (cent * cent).sum(1)[None]).argmax(dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        counts = torch.bincount(assign, minlength=k).float()
        new = torch.where(counts[:, None] > 0,
                          sums / counts.clamp_min(1.0)[:, None], cent)
        m2 = (torch.zeros_like(counts).index_add_(0, assign, xx)
              / counts.clamp_min(1.0)) - (new * new).sum(1)
        cent = new
        if balance and i < iters - 2:
            recv = torch.argsort(counts, stable=True)   # starved first
            donor = recv.flip(0)                         # fat first
            adopt = ((counts[recv] < 0.5 * fair)
                     & (counts[donor] > 1.5 * fair))
            sig = 0.3 * torch.sqrt(m2[donor].clamp_min(0.0) / cent.shape[1])
            noise = torch.randn(cent.shape, generator=generator,
                                device=cent.device)
            jittered = cent[donor] + sig[:, None] * noise
            cent = cent.clone()
            cent[recv] = torch.where(adopt[:, None], jittered, cent[recv])
    return cent
