"""The chain's codebooks (``chain/codebook.py``) and the archetype
registry (``store/delta_vector.py``) run their k-means on a ``device``:
the card by default, the chain's or the node's own where they belong to
one. Above 262,144 elements both packages leave numpy for their Lloyd
steps (JAX on its default device, the port on ``device``); on the CPU the
port's centroids equal the JAX package's within 1e-4 (the same k-means++
seeds, then float32 sums in another order), and the anomaly threshold
(the p99 of the training distances, x 1.5) within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from neumann_tpu.chain.codebook import GlobalCodebook as JBook
from neumann_tpu.store.delta_vector import ArchetypeRegistry as JRegistry
from neumann_tpu.store.delta_vector import KMeansConfig as JKMeans
from neumann_tpu_torch.chain.cluster import ClusterNode, TransportHub
from neumann_tpu_torch.chain.codebook import CodebookManager
from neumann_tpu_torch.chain.codebook import GlobalCodebook as TBook
from neumann_tpu_torch.router import QueryRouter
from neumann_tpu_torch.store.delta_vector import ArchetypeRegistry as TRegistry
from neumann_tpu_torch.store.delta_vector import KMeansConfig as TKMeans

ATOL = 1e-4


def _clusters(n=4096, d=96, k=8, seed=0):
    """n x d = 393,216 elements: above the numpy cut-off."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((k, d)) * 4
    x = cents[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d))
    return x.astype(np.float32)


def test_global_codebook_on_device_matches_jax():
    x = _clusters()
    j, t = JBook(96, 8), TBook(96, 8, device="cpu")
    j.train(x)
    t.train(x)
    np.testing.assert_allclose(t.codes, j.codes, rtol=0, atol=ATOL)
    assert t._threshold == pytest.approx(j._threshold, rel=1e-4)
    assert [t.quantize(v)[0] for v in x[:64]] == \
        [j.quantize(v)[0] for v in x[:64]]


def test_archetype_registry_on_device_matches_jax():
    x = _clusters(seed=1)
    j, t = JRegistry(threshold=0.001), TRegistry(threshold=0.001,
                                                 device="cpu")
    assert j.discover_archetypes(x, JKMeans(k=8)) == \
        t.discover_archetypes(x, TKMeans(k=8)) == 8
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=ATOL)
    assert [dv.archetype for dv in t.encode_batch(x[:64])] == \
        [dv.archetype for dv in j.encode_batch(x[:64])]


def test_card_by_default_and_the_owners_device():
    """Each takes the card unless asked; the chain takes its router's
    device, the in-process node its own, and so do their k-means."""
    assert TBook(4).device == CodebookManager().device == \
        TRegistry().device == "cuda"
    router = QueryRouter(device="cpu")
    router.init_chain()
    assert router.chain.codebooks.device == "cpu"
    node = ClusterNode("n0", ["n0"], TransportHub(), device="cpu")
    assert node.device == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_not_replaced_by_the_cpu():
    """With no card, a codebook left on its default device fails where
    its k-means needs the device: no quiet CPU route."""
    with pytest.raises((AssertionError, RuntimeError)):
        TBook(96, 8).train(_clusters())
    with pytest.raises((AssertionError, RuntimeError)):
        TRegistry().discover_archetypes(_clusters(), TKMeans(k=8))
