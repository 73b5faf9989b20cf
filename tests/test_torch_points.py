"""The port's Points plane on the CPU: the PointsService handlers of
``NeumannServer`` (Query, QueryBatch, the QueryStream pipeline through
the batcher's completion callback) and the native points codec
(``native/pypoints.py`` building ``native/points_ext.cpp``).

tests/test_points_serving.py and test_points_codec.py run on the port as
their twins (the JAX side runs in its own files). Then the port's native
codec and its protobuf shim give the same bytes as the JAX package's
codec, the batcher's callback fires exactly once on results, on a failed
cohort and on close, and a pipeline whose stream ends leaves no future
unresolved.
"""

import numpy as np
import pytest

from tests.torch_twins import twin_tests

globals().update(twin_tests("test_points_serving", packages=("port",)))
globals().update(twin_tests("test_points_codec", packages=("port",)))


# ------------------------------------------------ the codecs, byte for byte

_QUERIES = [
    ("docs", [1.5, -2.25, 3.0], 7, '{"op":"eq"}', True, "dot", 99),
    ("", [0.5], 0, None, False, None, 0),
    ("c1", np.linspace(-1, 1, 768).tolist(), 10, None, False, "cosine",
     (1 << 40) + 3),
    ("", [], 0, None, False, None, 0),
]
_RESPONSES = [
    (5, ["a", "bb"], [0.5, -1.25], ['{"x":1}', None], None),
    (7, [], [], None, "no collection 'nope'"),
    ((1 << 33) + 1, [f"k{i}" for i in range(64)],
     np.linspace(0.01, 1, 64).tolist(), None, None),
    (9, ["z", "y"], [0.0, -3.0], None, None),
]


def _codecs():
    from neumann_tpu.native import pypoints as jpoints
    from neumann_tpu_torch.native import pypoints as tpoints
    from neumann_tpu_torch.server.server import _PbPointsCodec

    native = tpoints.load()
    assert native is not None, "the port's native points codec must build"
    return {"port native": native, "port shim": _PbPointsCodec,
            "jax native": jpoints.load()}


@pytest.mark.parametrize("query", _QUERIES, ids=range(len(_QUERIES)))
def test_native_codec_and_shim_encode_queries_alike(query):
    col, vec, limit, filt, wp, metric, rid = query
    vecb = np.asarray(vec, "<f4").tobytes()
    raws = {name: c.encode_query(col, vecb, limit, filt, wp, metric, rid)
            for name, c in _codecs().items() if c is not None}
    assert len(set(raws.values())) == 1, raws
    raw = raws["port native"]
    parsed = [c.parse_query(raw) for c in _codecs().values()
              if c is not None]
    assert all(p == parsed[0] for p in parsed), parsed
    assert parsed[0] == (col, vecb, limit, filt, wp, metric, rid)


@pytest.mark.parametrize("resp", _RESPONSES, ids=range(len(_RESPONSES)))
def test_native_codec_and_shim_encode_responses_alike(resp):
    rid, ids, scores, payloads, error = resp
    sb = np.asarray(scores, "<f4").tobytes()
    codecs = {n: c for n, c in _codecs().items() if c is not None}
    raws = {name: c.encode_response(rid, ids, sb, payloads, error)
            for name, c in codecs.items()}
    if 0.0 in scores:
        # a score of exactly 0: both native codecs write the field,
        # protobuf leaves it out as proto3's default; each parses both
        assert raws["port native"] == raws.get("jax native",
                                               raws["port native"])
        assert len(raws["port shim"]) < len(raws["port native"])
        assert codecs["port native"].parse_response(raws["port shim"]) \
            == codecs["port shim"].parse_response(raws["port native"])
        del raws["port shim"]
    assert len(set(raws.values())) == 1, raws
    raw = raws["port native"]
    parsed = [c.parse_response(raw) for c in codecs.values()]
    assert all(p == parsed[0] for p in parsed), parsed
    joined = {name: c.join_messages([raw, raw[:0], raw])
              for name, c in codecs.items()}
    assert len(set(joined.values())) == 1
    for c in codecs.values():
        assert c.split_messages(joined["port native"]) == [raw, b"", raw]


# ------------------------------------------------ the batcher's callback


class _Engine:
    """A stand-in engine: results name the query's first value; a query
    whose first value is negative makes any batch holding it raise."""

    def __init__(self, gate=None):
        import threading

        self.calls = []
        self.gate = gate
        self.entered = threading.Event()

    def batch_search_ns(self, q, k, metric, ns, filter_cond=None):
        from neumann_tpu_torch.engines.vector import SearchResult

        self.entered.set()
        if self.gate is not None:
            self.gate.wait()
        self.calls.append(len(q))
        if (q[:, 0] < 0).any():
            raise ValueError("negative query")
        return [[SearchResult(f"r{int(row[0])}", float(row[0]))] * k
                for row in q]


def _recorder():
    import threading

    seen, lock = {}, threading.Lock()

    def cb_for(i):
        def cb(results, error):
            with lock:
                seen.setdefault(i, []).append((results, error))
        return cb

    return seen, cb_for


def _wait_for(pred, timeout=10.0):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.01)
    assert pred()


def test_batcher_callback_fires_once_on_results():
    from neumann_tpu_torch.server.batcher import QueryBatcher

    b = QueryBatcher(_Engine(), dim=2, max_wait_ms=20.0, workers=2)
    seen, cb_for = _recorder()
    try:
        reqs = [b.submit(np.array([i, 0], np.float32), 2, callback=cb_for(i))
                for i in range(16)]
        _wait_for(lambda: len(seen) == 16)
        for r in reqs:
            assert r.event.wait(5)
    finally:
        b.close()
    for i in range(16):
        assert len(seen[i]) == 1
        results, error = seen[i][0]
        assert error is None and [h.key for h in results] == [f"r{i}"] * 2
    assert b.batches_run < 16          # coalesced into cohorts


def test_batcher_callback_fires_once_on_a_failed_cohort():
    """A cohort whose device call raises is re-run one request at a
    time: each request's callback fires once, the bad one's with its
    error, the others' with their results."""
    import threading

    from neumann_tpu_torch.server.batcher import QueryBatcher

    gate = threading.Event()
    eng = _Engine(gate)
    b = QueryBatcher(eng, dim=2, max_wait_ms=0.0, workers=1)
    seen, cb_for = _recorder()
    try:
        # the first request holds the worker until all are queued, so the
        # rest form one cohort
        b.submit(np.array([100, 0], np.float32), 1, callback=cb_for(100))
        assert eng.entered.wait(5)
        for i in (1, -1, 2, 3):
            b.submit(np.array([i, 0], np.float32), 1, callback=cb_for(i))
        gate.set()
        _wait_for(lambda: len(seen) == 5)
    finally:
        b.close()
    assert eng.calls == [1, 4, 1, 1, 1, 1]
    assert {i: len(v) for i, v in seen.items()} == dict.fromkeys(
        (100, 1, -1, 2, 3), 1)
    assert isinstance(seen[-1][0][1], ValueError) and seen[-1][0][0] is None
    for i in (1, 2, 3):
        assert seen[i][0][1] is None and seen[i][0][0][0].key == f"r{i}"


def test_batcher_callback_fires_once_on_close():
    """Closing with a request still queued (its worker gone) fires its
    callback once with ``BatcherClosed``; a callback that raises is
    logged, and fires no second time."""
    from neumann_tpu_torch.server.batcher import BatcherClosed, QueryBatcher

    b = QueryBatcher(_Engine(), dim=2, max_wait_ms=0.0, workers=1)
    b._stop.set()                       # the worker leaves at once ...
    with b._cond:
        b._cond.notify_all()
    b._threads[0].join(5)
    seen, cb_for = _recorder()
    b._stop.clear()                     # ... and the queue takes requests
    b.submit(np.array([1, 0], np.float32), 1, callback=cb_for(1))

    def raising(results, error):
        cb_for(2)(results, error)
        raise RuntimeError("a faulty callback")

    b.submit(np.array([2, 0], np.float32), 1, callback=raising)
    b.close()
    assert {i: len(v) for i, v in seen.items()} == {1: 1, 2: 1}
    for i in (1, 2):
        assert seen[i][0][0] is None
        assert isinstance(seen[i][0][1], BatcherClosed)
    with pytest.raises(BatcherClosed):
        b.submit(np.array([3, 0], np.float32), 1, callback=cb_for(3))
    assert 3 not in seen


# ------------------------------------------------ a pipeline's clean end


def test_pipeline_ended_cleanly_leaves_no_future_unresolved():
    """A QueryStream the server ends without answering (cleanly, status
    OK) fails every pending future of the port's ``PointsPipeline``, and
    any search made after it; the reference left them pending."""
    from concurrent import futures

    import grpc

    from neumann_tpu_torch.server.client import NeumannClient
    from neumann_tpu_torch.utils.errors import NeumannError

    def end_after_two(request_iterator, context):
        for i, _ in enumerate(request_iterator):
            if i == 1:
                return
        yield b""                       # never reached

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers([grpc.method_handlers_generic_handler(
        "neumann.PointsService", {
            "QueryStream": grpc.stream_stream_rpc_method_handler(
                end_after_two)})])
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    cli = NeumannClient.connect(f"127.0.0.1:{port}")
    try:
        pipe = cli.points_pipeline()
        futs = [pipe.search([1.0, 0.0], 3) for _ in range(4)]
        for f in futs:
            with pytest.raises(NeumannError, match="query stream"):
                f.result(timeout=10)
        late = pipe.search([1.0, 0.0], 3)
        with pytest.raises(NeumannError):
            late.result(timeout=1)
        pipe.close()
    finally:
        cli.close()
        server.stop(0)


def test_batcher_callbacks_fire_once_under_thread_stress():
    """More workers than cores and a short switch interval: every one of
    2,048 requests submitted from 32 threads gets exactly one callback
    (a lost or doubled one would break the count)."""
    import sys
    import threading

    from neumann_tpu_torch.server.batcher import QueryBatcher

    b = QueryBatcher(_Engine(), dim=2, max_wait_ms=0.5, workers=16)
    seen, cb_for = _recorder()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submit(t):
            for j in range(64):
                i = t * 64 + j
                b.submit(np.array([i, 0], np.float32), 1,
                         callback=cb_for(i))

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        _wait_for(lambda: len(seen) == 2048, timeout=30)
    finally:
        sys.setswitchinterval(interval)
        b.close()
    assert all(len(v) == 1 for v in seen.values())
    assert all(v[0][1] is None and v[0][0][0].key == f"r{i}"
               for i, v in seen.items())
    assert b.queries_served == 2048
