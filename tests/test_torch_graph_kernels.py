"""The port's graph analytics (neumann_tpu_torch/ops/graph_kernels.py)
against the JAX package's (neumann_tpu/ops/graph_kernels.py), on the CPU.

Seeded random edge lists over a padded node range with some slots
invalid, in five shapes: a sparse directed graph, one with self-loops
and duplicate edges, an undirected one (both directions passed), a
chain (deep BFS, slow label propagation) and a graph with no edges at
all. BFS levels, component labels and degree counts must be equal
exactly; PageRank within rtol 1e-5 (float sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import graph_kernels as jg
from neumann_tpu_torch.ops import graph_kernels as tg

SHAPES = ("sparse", "self_loops", "undirected", "chain", "empty")


def _graph(shape, seed):
    """(src, dst, n, valid) as numpy int32 / bool arrays."""
    rng = np.random.default_rng(seed)
    n = 97
    valid = rng.random(n) < 0.9
    live = np.flatnonzero(valid)
    if shape == "empty":
        src = dst = np.zeros(0, np.int32)
    elif shape == "chain":
        src, dst = live[:-1], live[1:]
    else:
        m = 160
        src = rng.choice(live, m)
        dst = rng.choice(live, m)
        if shape == "self_loops":
            loops = rng.choice(live, 12)
            src = np.concatenate([src, loops, src[:20]])
            dst = np.concatenate([dst, loops, dst[:20]])
        if shape == "undirected":
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32), n,
            valid)


def _both(src, dst, valid):
    return ((jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid)),
            (torch.from_numpy(src.astype(np.int64)),
             torch.from_numpy(dst.astype(np.int64)),
             torch.from_numpy(valid)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("max_depth", [0, 1, 3])
def test_bfs_levels(shape, max_depth):
    src, dst, n, valid = _graph(shape, 1)
    (js, jd, _), (ts, td, _) = _both(src, dst, valid)
    start = np.zeros(n, bool)
    start[np.flatnonzero(valid)[[0, 5]]] = True
    want = np.asarray(jg.bfs_levels(js, jd, n, jnp.asarray(start),
                                    max_depth))
    got = tg.bfs_levels(ts, td, n, torch.from_numpy(start),
                        max_depth).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if shape == "chain" and max_depth:
        assert got.max() == max_depth


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_pagerank(shape, seed):
    src, dst, n, valid = _graph(shape, seed)
    (js, jd, jv), (ts, td, tv) = _both(src, dst, valid)
    want = np.asarray(jg.pagerank(js, jd, n, jv, 0.85, 20))
    got = tg.pagerank(ts, td, n, tv, 0.85, 20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.all(got[~valid] == 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7])
def test_connected_components(shape, seed):
    src, dst, n, valid = _graph(shape, seed)
    bs, bd = np.concatenate([src, dst]), np.concatenate([dst, src])
    (js, jd, jv), (ts, td, tv) = _both(bs, bd, valid)
    want = np.asarray(jg.connected_components(js, jd, n, jv))
    got = tg.connected_components(ts, td, n, tv).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_degree_counts(shape):
    src, dst, n, valid = _graph(shape, 3)
    (js, _, _), (ts, _, _) = _both(src, dst, valid)
    np.testing.assert_array_equal(tg.degree_counts(ts, n).numpy(),
                                  np.asarray(jg.degree_counts(js, n)))


def test_dummy_self_loop_of_an_empty_graph():
    """The engines' edge arrays carry one self-loop on slot 0 when the
    graph has no edges (graph.py ``_edge_arrays``), with every slot
    invalid when it has no nodes either."""
    n = 1
    one = np.zeros(1, np.int32)
    valid = np.zeros(n, bool)
    (js, jd, jv), (ts, td, tv) = _both(one, one, valid)
    np.testing.assert_array_equal(
        tg.pagerank(ts, td, n, tv).numpy(),
        np.asarray(jg.pagerank(js, jd, n, jv)))
    np.testing.assert_array_equal(
        tg.connected_components(ts, td, n, tv).numpy(),
        np.asarray(jg.connected_components(js, jd, n, jv)))
    start = np.ones(n, bool)
    np.testing.assert_array_equal(
        tg.bfs_levels(ts, td, n, torch.from_numpy(start)).numpy(),
        np.asarray(jg.bfs_levels(js, jd, n, jnp.asarray(start))))
