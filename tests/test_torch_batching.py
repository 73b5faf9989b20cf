"""The port's query batcher, batched serving and warm-up against the JAX
package's.

The ten cases of tests/test_batched_serving.py run on a port router
(CPU) and a JAX router fed the same numpy data; hits are equal (keys in
order, scores within 1e-5). Then what the port does differently: its
cohorts run unpadded and give the JAX padded batcher's results; a
filter that cannot be hashed, or that fails, fails no other request and
leaves the workers serving; a request whose caller timed out leaves the
queue. Last, both engines' and routers' warm-ups make the same number
of calls on the same corpora.
"""

import threading
import time

import numpy as np
import pytest

from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.server.batcher import _Request as JRequest
from neumann_tpu_torch.engines.vector import FilterCondition as TFilter
from neumann_tpu_torch.engines.vector import VectorCollectionConfig as TCC
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.server.batcher import BatcherClosed, _Request

D = 16


@pytest.fixture
def routers():
    vecs = np.random.default_rng(3).standard_normal((64, D)).astype(
        np.float32)
    jr = JRouter()
    jr.vector.config.mesh_auto = False
    tr = TRouter(device="cpu")
    for r in (jr, tr):
        for i, v in enumerate(vecs):
            r.vector.store_embedding(f"e{i}", v, metadata={"grp": i % 2})
    yield jr, tr, vecs
    for r in (jr, tr):
        r.disable_batched_serving()


def _similar(vec, k=3):
    return "SIMILAR [" + ",".join(f"{x:.5f}" for x in vec) + f"] TOP {k}"


def _same(got, want, atol=1e-5):
    """Hits equal: keys in order, scores within 1e-5 (dicts from the
    router or SearchResults from a batcher)."""
    def pairs(hits):
        return [(h["key"], h["score"]) if isinstance(h, dict)
                else (h.key, h.score) for h in hits]

    g, w = pairs(got), pairs(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                               rtol=0, atol=atol)


def _concurrently(n, fn):
    out = [None] * n
    start = threading.Barrier(n)

    def worker(i):
        start.wait()
        out[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


# -- the ten cases of tests/test_batched_serving.py, on both routers ------

def test_embedded_default_is_unbatched(routers):
    jr, tr, vecs = routers
    assert jr._batchers is None and tr._batchers is None
    got = tr.execute(_similar(vecs[5])).results
    assert got[0]["key"] == "e5"
    _same(got, jr.execute(_similar(vecs[5])).results)


def test_batched_routing_matches_unbatched(routers):
    jr, tr, vecs = routers
    want = [jr.execute(_similar(v)).results for v in vecs[:8]]
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=1.0)
    for r in (jr, tr):
        for v, w in zip(vecs[:8], want):
            _same(r.execute(_similar(v)).results, w)
    assert tr._batchers[("", D, "cosine")].queries_served >= 8


def test_concurrent_queries_coalesce(routers):
    jr, tr, vecs = routers
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=20.0)
    got = {id(r): _concurrently(
        12, lambda i, r=r: r.execute(_similar(vecs[i])).results)
        for r in (jr, tr)}
    for i in range(12):
        assert got[id(tr)][i][0]["key"] == f"e{i}"
        _same(got[id(tr)][i], got[id(jr)][i])
    b = tr._batchers[("", D, "cosine")]
    assert b.queries_served >= 12
    assert b.batches_run < 12


def test_metric_variants_coalesce_in_own_bucket(routers):
    """Batched equals unbatched exactly within each package. Across the
    packages the top hit's distance (the query is e2 to 5 decimals) is
    the square root of an f32 cancellation residual, about
    sqrt(2^-24 * |q|^2) ~ 1e-3 for |q|^2 ~ 16, so its 1/(1+d) score
    agrees to 2e-3; the other hits to 1e-5."""
    jr, tr, vecs = routers
    stmt = _similar(vecs[2]) + " METRIC euclidean"
    want = {id(r): r.execute(stmt).results for r in (jr, tr)}
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=1.0)
        res = r.execute(stmt).results
        assert res[0]["key"] == "e2"
        assert res == want[id(r)]
    _same(want[id(tr)][:1], want[id(jr)][:1], atol=2e-3)
    _same(want[id(tr)][1:], want[id(jr)][1:])
    assert tr._batchers[("", D, "euclidean")].queries_served >= 1
    assert ("", D, "cosine") not in tr._batchers


def test_filtered_queries_coalesce_by_filter(routers):
    jr, tr, vecs = routers
    stmt = [_similar(vecs[i]) + f" WHERE grp = {i % 2}" for i in range(8)]
    want = [jr.execute(s).results for s in stmt]
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=20.0)
    got = {id(r): _concurrently(8, lambda i, r=r: r.execute(stmt[i]).results)
           for r in (jr, tr)}
    for i in range(8):
        for r in (jr, tr):
            _same(got[id(r)][i], want[i])
        assert got[id(tr)][i][0]["key"] == f"e{i}"
        assert all(int(h["key"][1:]) % 2 == i % 2 for h in got[id(tr)][i])
    b = tr._batchers[("", D, "cosine")]
    assert b.queries_served >= 8
    assert b.batches_run < 8


def test_collection_queries_coalesce(routers):
    jr, tr, vecs = routers
    for r in (jr, tr):
        r.vector.create_collection("docs")
        for i in range(16):
            r.vector.store_in_collection("docs", f"d{i}", vecs[i])
        r.enable_batched_serving(max_wait_ms=1.0)
    res = tr.execute(_similar(vecs[4]) + " IN docs").results
    assert res[0]["key"] == "d4"
    _same(res, jr.execute(_similar(vecs[4]) + " IN docs").results)
    assert tr._batchers[("col/docs", D, "cosine")].queries_served >= 1


def test_bad_request_fails_alone(routers):
    jr, tr, vecs = routers
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=5.0)
        b = r._batcher_for(D)
        with pytest.raises(ValueError):
            b.search(np.zeros(7, np.float32), 3)
        with pytest.raises(ValueError):
            b.search(vecs[0], 0)
    _same(tr._batcher_for(D).search(vecs[3], 3),
          jr._batcher_for(D).search(vecs[3], 3))


def test_cohort_failure_isolation(routers):
    """A poisoned cohort is re-run per request: only the poisoned
    request fails, the other 15 get the JAX batcher's hits."""
    jr, tr, vecs = routers
    poison = np.full(D, 7.25, np.float32)
    got = {}
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=30.0)
        b = r._batcher_for(D)
        real = r.vector.batch_search_ns

        def flaky(q, k, metric=None, ns="", real=real, **kw):
            q = np.asarray(q)
            if bool((q == 7.25).all(axis=1).any()):
                raise RuntimeError("poisoned")
            return real(q, k, metric, ns, **kw)

        r.vector.batch_search_ns = flaky
        try:
            def call(i, b=b):
                try:
                    return b.search(poison if i == 7 else vecs[i], 3)
                except Exception as e:  # noqa: BLE001
                    return e

            got[id(r)] = _concurrently(16, call)
        finally:
            r.vector.batch_search_ns = real
    assert isinstance(got[id(tr)][7], RuntimeError)
    for i in range(16):
        if i != 7:
            assert got[id(tr)][i][0].key == f"e{i}"
            _same(got[id(tr)][i], got[id(jr)][i])


def test_close_drains_queue(routers):
    _, tr, vecs = routers
    tr.enable_batched_serving(max_wait_ms=1.0)
    b = tr._batcher_for(D)
    got = []

    def worker():
        try:
            got.append(b.search(vecs[0], 3, timeout_s=5.0))
        except (BatcherClosed, TimeoutError) as e:
            got.append(e)

    t = threading.Thread(target=worker)
    t.start()
    b.close()
    t.join(timeout=6.0)
    assert not t.is_alive()
    assert len(got) == 1
    assert isinstance(got[0], (list, BatcherClosed))


def test_disable_closes_batchers(routers):
    jr, tr, vecs = routers
    tr.enable_batched_serving(max_wait_ms=1.0)
    tr.execute(_similar(vecs[0]))
    b = tr._batchers[("", D, "cosine")]
    tr.disable_batched_serving()
    assert tr._batchers is None
    assert b._stop.is_set()
    got = tr.execute(_similar(vecs[1])).results
    assert got[0]["key"] == "e1"
    _same(got, jr.execute(_similar(vecs[1])).results)


# -- the port's departures -------------------------------------------------

@pytest.mark.parametrize("size", [1, 3, 5, 17, 70])
@pytest.mark.parametrize("filtered", [False, True])
def test_unpadded_cohort_equals_padded(routers, size, filtered):
    """A cohort runs at its own size; its hits equal the JAX batcher's,
    which pads the cohort to a bucket (4, 16, 64 or 256) first."""
    jr, tr, vecs = routers
    rng = np.random.default_rng(size)
    qs = vecs[rng.integers(0, 64, size)] + 0.1 * rng.standard_normal(
        (size, D)).astype(np.float32)
    ks = rng.integers(1, 6, size)
    jf = tf = None
    if filtered:
        from neumann_tpu.engines.vector import FilterCondition as JFilter

        jf, tf = JFilter.eq("grp", 1), TFilter.eq("grp", 1)
    for r in (jr, tr):
        r.enable_batched_serving(max_wait_ms=1.0)
    jb, tb = jr._batcher_for(D), tr._batcher_for(D)
    sizes = []
    real = tr.vector.batch_search_ns

    def spy(q, *a, **kw):
        sizes.append(np.asarray(q).shape[0])
        return real(q, *a, **kw)

    tr.vector.batch_search_ns = spy
    try:
        jreq = [JRequest(q, int(k), jf) for q, k in zip(qs, ks)]
        treq = [_Request(q, int(k), tf) for q, k in zip(qs, ks)]
        jb._run_cohort(jf, jreq)
        tb._run_cohort(tf, treq)
    finally:
        tr.vector.batch_search_ns = real
    assert sizes == [size]
    for a, b, k in zip(treq, jreq, ks):
        assert a.error is None and len(a.result) == k
        _same(a.result, b.result)


def test_unhashable_in_filter_is_served_and_workers_live(routers):
    """An ``in`` filter built with a list value cannot be hashed (the
    JAX batcher's worker dies grouping it). The port freezes it into a
    hashable key: the cohort is served under the filter, and the next
    plain query is answered."""
    _, tr, vecs = routers
    tr.enable_batched_serving(max_wait_ms=5.0)
    b = tr._batcher_for(D)
    filt = TFilter("in", "grp", [1])
    with pytest.raises(TypeError):
        hash(filt)
    got = _concurrently(4, lambda i: b.search(vecs[i], 3, timeout_s=10.0,
                                              filter_cond=filt))
    want = [tr.vector.search_similar_filtered(vecs[i], 3, TFilter.in_(
        "grp", [1])) for i in range(4)]
    for g, w in zip(got, want):
        _same(g, w)
        assert all(int(h.key[1:]) % 2 == 1 for h in g)
    assert b.search(vecs[6], 3, timeout_s=10.0)[0].key == "e6"
    # a dict value (JSON can send one) stays unhashable once frozen: the
    # request runs as a cohort of its own, and matches no row here
    assert b.search(vecs[5], 3, timeout_s=10.0, filter_cond=TFilter(
        "eq", "grp", {"a": 1})) == []
    assert all(t.is_alive() for t in b._threads)


def test_failing_filter_fails_only_its_requests(routers):
    """A filter that raises while it is evaluated fails its own cohort's
    requests; a concurrent plain cohort and the next query are served."""
    _, tr, vecs = routers
    tr.enable_batched_serving(max_wait_ms=20.0)
    b = tr._batcher_for(D)
    bad = TFilter("no_such_op", "grp", 1)

    def call(i):
        try:
            return b.search(vecs[i], 3, timeout_s=10.0,
                            filter_cond=bad if i % 2 else None)
        except Exception as e:  # noqa: BLE001
            return e

    got = _concurrently(8, call)
    for i, g in enumerate(got):
        if i % 2:
            assert isinstance(g, Exception) and "no_such_op" in str(g)
        else:
            assert g[0].key == f"e{i}"
    assert b.search(vecs[9], 3, timeout_s=10.0)[0].key == "e9"
    assert all(t.is_alive() for t in b._threads)


def test_timed_out_request_leaves_the_queue(routers):
    """With the one worker held in a device call, a second request times
    out: it leaves the queue, and is never run once the worker frees."""
    from neumann_tpu_torch.server.batcher import QueryBatcher

    _, tr, vecs = routers
    release = threading.Event()
    ran = []
    real = tr.vector.batch_search_ns

    def held(q, *a, **kw):
        ran.append(np.asarray(q).copy())
        release.wait(10.0)
        return real(q, *a, **kw)

    tr.vector.batch_search_ns = held
    b = QueryBatcher(tr.vector, D, max_wait_ms=0.0, workers=1)
    try:
        first = b.submit(vecs[0], 3)
        deadline = time.monotonic() + 10.0
        while not ran and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(ran) == 1                # the worker is held
        with pytest.raises(TimeoutError):
            b.search(vecs[1], 3, timeout_s=0.05)
        assert b._queue == []
        release.set()
        assert first.event.wait(10.0) and first.result[0].key == "e0"
        assert b.search(vecs[2], 3, timeout_s=10.0)[0].key == "e2"
        assert len(ran) == 2                # vecs[1] never ran
        assert not any(np.array_equal(q[0], vecs[1]) for q in ran)
    finally:
        release.set()
        tr.vector.batch_search_ns = real
        b.close()


def test_warmup_counts_equal_the_jax_counts(routers):
    """Engine and router warm-ups make the JAX package's calls on the
    same corpora: every default-namespace dim at every bucket and k,
    then each collection with a dimension once per k."""
    from neumann_tpu.engines.vector import VectorCollectionConfig as JCC

    jr, tr, vecs = routers
    rng = np.random.default_rng(5)
    extra = rng.standard_normal((8, 8)).astype(np.float32)
    for r, cc in ((jr, JCC), (tr, TCC)):
        for i, v in enumerate(extra):
            r.vector.store_embedding(f"x{i}", v)
        r.vector.create_collection("docs", cc(dimension=D))
        r.vector.create_collection("loose")         # no dimension: skipped
        for i in range(8):
            r.vector.store_in_collection("docs", f"d{i}", vecs[i])
    for kw in ({}, dict(buckets=(1, 4), top_ks=(3,))):
        want = jr.vector.warmup(**kw)
        assert tr.vector.warmup(**kw) == want
    assert tr.warmup() == jr.warmup() == 2 * 5 * 2 + 2
    assert tr.warmup(buckets=(1,), top_ks=(10,)) == 3
