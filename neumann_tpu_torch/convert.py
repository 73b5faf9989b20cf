"""Carry state from the JAX package to the port.

``ivf_state_from_jax(ivf)`` reads a built ``neumann_tpu.ops.ivf.
DeviceIVFInt8`` (with its delta plane and tombstones, if ``add`` or
``delete`` mutated it) as host numpy arrays, through ``np.asarray`` only
(this module never imports JAX: the arrays convert themselves).
``neumann_tpu_torch.ops.ivf.DeviceIVFInt8.from_state(state, device)``
then gives the port the same index, so both packages can search one
layout. (Their k-means inits differ by construction — ``jax.random``
and ``torch.Generator`` draw different numbers — so two independent
builds do not give the same layout.)

``collection_state_from_jax(engine, name)`` reads one collection of a
JAX ``VectorEngine`` (its config, keys, vectors and metadata) as host
values, for the port's ``create_collection`` / ``store_in_collection``.
Collection snapshots need no converter: both packages write and read
the same ``.npz`` format (``snapshot_collection`` /
``load_collection_snapshot``).

``pq_from_jax(book, codes, device)``, ``ivf_index_from_jax(ivf,
device)`` and ``hnsw_from_jax(index)`` give the port a trained JAX
``PQCodebook`` (its codebooks, and its codes as uint8), a JAX legacy
``IVFIndex`` (centroids, padded layout, row ids and its f32 / PQ-code /
sign-bit plane) and a JAX ``HNSWIndex`` (through its bytes, which both
packages read and write alike), so both packages search one trained
state.

``llm_cache_from_jax(cache)`` gives the port a JAX ``LLMCache``: its
settings, entries, TTLs, statistics, embedding layer and semantic HNSW
graph (through its bytes), so the same lookups give the same answers.
Checkpoint directories need no converter: ``index.json`` and the
snapshots are the same bytes in both packages.

``chain_from_jax(jax_chain, store)`` gives the port a JAX
``TensorChain`` over ``store`` (a port store holding the same rows): its
blocks (hashes, signatures and codebook codes as they are), its
codebooks (the global book's codes and anomaly threshold, each domain's
local book and usage, the deltas still waiting to train it, the
transition log), its consensus settings, signing key, counters and next
transaction id, so CHAIN VERIFY, HEIGHT, HISTORY and the codebook
statements answer alike, and the next commit appends the same block.
The state root is the port chain's own, seeded from ``store``: equal to
the JAX chain's when the stores hold the same rows. A Raft node's WAL
directory needs no converter: both packages write the same bytes.

``partitioner_from_jax(part, device)`` gives the port a trained JAX
``SemanticPartitioner`` (its centroids), a ``VoronoiPartitioner`` (its
seeds) or a ``ConsistentHashPartitioner`` (its ring, owners, shards and
virtual-node count), so both packages assign every key and vector to
the same shard without training again.

``sharded_corpus_from_jax(sc, mesh)`` and ``sharded_ivf_from_jax(ivf,
mesh)`` give the port a JAX ``ShardedCorpus`` (its corpus, scale, sqnorm
and mask, read as global arrays) or ``ShardedIVFCorpus`` (its windowed
planes, probe centroids, window starts, row ids and probe settings),
placed on the port's ``mesh``, which must have as many devices along
the axis as the JAX placement has shards, so both packages search one
layout.

``router_from_files(wal_path, snapshot_path, device)`` gives a port
``QueryRouter`` over a store that the JAX package's router wrote (its
``checkpoint`` snapshot and the WAL after it; both packages write the
same bytes): the engines rebuild tables, nodes, edges and entity
embeddings through their store hooks, and ``QueryRouter.recover``
rebuilds the unified engine's key -> node map from the recovered graph.
"""

from __future__ import annotations

import copy

import numpy as np

IVF_STATE_KEYS = ("centroids", "_buf", "_rmult", "_scale", "_rbuf",
                  "_rscale", "_starts", "_row_ids", "_window", "nprobe",
                  "_fixed", "_kmeans_k", "_nprobe_cfg", "iters",
                  "max_read_frac", "_n", "_next_id", "_dbuf", "_drmult",
                  "_dscale", "_dids", "_dn", "_deleted", "_dead_ids")


def ivf_state_from_jax(ivf) -> dict:
    """Host copy of a built JAX ``DeviceIVFInt8``'s state: its layout,
    and the delta plane and tombstones of its ``add`` / ``delete``
    calls."""
    if getattr(ivf, "_buf", None) is None:
        raise ValueError("the JAX index is not built")
    state = {}
    for key in IVF_STATE_KEYS:
        value = getattr(ivf, key)
        if key == "_dead_ids":
            value = sorted(int(i) for i in value)
        elif value is not None:
            value = np.asarray(value)
        state[key] = value
    for key in ("_window", "nprobe", "_kmeans_k", "_nprobe_cfg", "iters",
                "_n", "_next_id", "_dn", "_deleted"):
        state[key] = int(state[key])
    state["max_read_frac"] = float(state["max_read_frac"])
    state["_fixed"] = bool(state["_fixed"])
    return state


def collection_state_from_jax(engine, name: str) -> dict:
    """Host copy of a JAX engine's collection: ``config`` (dimension,
    metric, quantization), ``keys`` [N] str, ``vectors`` [N, d] f32 and
    ``metadata`` (one dict of scalar fields per key), in store order."""
    cfg = engine.collection_config(name)
    prefix = f"col:{name}:"
    keys, vecs, metas = [], [], []
    for full in engine.store.scan(prefix):
        data = engine.store.get(full)
        emb = data.get("embedding") if data is not None else None
        if emb is None:
            continue
        keys.append(full[len(prefix):])
        vecs.append(np.asarray(emb.to_dense(), np.float32))
        metas.append({n: v.value for n, v in data.fields.items()
                      if n != "embedding" and v.kind == "scalar"})
    dim = cfg.dimension or (vecs[0].size if vecs else 0)
    return {"config": {"dimension": cfg.dimension, "metric": cfg.metric,
                       "quantization": cfg.quantization},
            "keys": np.array(keys, dtype=object),
            "vectors": (np.stack(vecs) if vecs
                        else np.zeros((0, dim), np.float32)),
            "metadata": metas}


def pq_from_jax(book, codes=None, device="cuda"):
    """(port ``PQCodebook``, codes [N, M] uint8 tensor or None) of a
    trained JAX ``PQCodebook`` and, optionally, codes it made (any
    integer dtype)."""
    from neumann_tpu_torch.ops.pq import PQCodebook, PQConfig

    if getattr(book, "codebooks", None) is None:
        raise ValueError("the JAX codebook is not trained")
    cfg = book.config
    port = PQCodebook.from_codebooks(
        np.asarray(book.codebooks, np.float32),
        PQConfig(n_subspaces=cfg.n_subspaces, n_centroids=cfg.n_centroids,
                 iters=cfg.iters), device)
    if codes is None:
        return port, None
    import torch

    c = np.asarray(codes)
    if c.min(initial=0) < 0 or c.max(initial=0) > 255:
        raise ValueError("PQ codes outside 0..255")
    return port, torch.from_numpy(c.astype(np.uint8)).to(device)


def ivf_index_from_jax(ivf, device="cuda"):
    """A port ``ops/ivf.IVFIndex`` holding a built JAX ``IVFIndex``'s
    state: config, centroids, stride, row ids, cluster counts, the
    storage plane (f32 rows, PQ codes as uint8 with the codebook, or the
    uint32 sign-bit words as int32) and the originals it relayouts
    from."""
    import torch

    from neumann_tpu_torch.ops.ivf import IVFConfig, IVFIndex

    if getattr(ivf, "_row_ids", None) is None:
        raise ValueError("the JAX index has no rows (add() first)")
    c = ivf.config
    port = IVFIndex(ivf.dim, IVFConfig(
        n_clusters=c.n_clusters, nprobe=c.nprobe, iters=c.iters,
        storage=c.storage, pq_subspaces=c.pq_subspaces), device=device)
    port.centroids = np.asarray(ivf.centroids, np.float32).copy()
    port._row_ids = np.asarray(ivf._row_ids, np.int32).copy()
    port._stride = int(ivf._stride)
    port._n = int(ivf._n)
    if getattr(ivf, "_counts", None) is not None:
        port._counts = np.asarray(ivf._counts).copy()
    if getattr(ivf, "_host_v", None) is not None:
        port._v = torch.from_numpy(np.array(
            ivf._host_v, np.float32)).to(device)
    if c.storage == "pq":
        port._pq, port._codes = pq_from_jax(ivf._pq, ivf._codes, device)
    elif c.storage == "binary":
        port._bits = torch.from_numpy(
            np.array(ivf._bits).view(np.int32)).to(device)
    else:
        port._reordered = torch.from_numpy(np.array(
            ivf._reordered, np.float32)).to(device)
    return port


def hnsw_from_jax(index):
    """A port ``ops/hnsw.HNSWIndex`` equal to a JAX ``HNSWIndex`` (its
    ``to_bytes()``, read by the port's ``from_bytes``)."""
    from neumann_tpu_torch.ops.hnsw import HNSWIndex

    return HNSWIndex.from_bytes(index.to_bytes())


def llm_cache_from_jax(cache):
    """A port ``cache/llm_cache.LLMCache`` holding a JAX ``LLMCache``'s
    state. The JAX package's default embedder becomes the port's (the
    same function); another embedder is a plain callable and carries
    over as it is."""
    from dataclasses import asdict

    from neumann_tpu_torch.cache import llm_cache

    embedder = cache.embedder
    if getattr(embedder, "__qualname__", None) == "default_embedder" and \
            embedder.__module__.endswith(".cache.llm_cache"):
        embedder = llm_cache.default_embedder
    port = llm_cache.LLMCache(
        capacity=cache.capacity, default_ttl_s=cache.default_ttl_s,
        semantic_threshold=cache.semantic_threshold,
        eviction=cache.eviction, embedder=embedder, metric=cache.metric,
        auto_select_metric=cache.auto_select_metric,
        sparsity_metric_threshold=cache.sparsity_metric_threshold,
        embedding_capacity=cache.embedding_capacity)
    port._exact = {k: llm_cache._Entry(**asdict(e))
                   for k, e in cache._exact.items()}
    port._ttl_heap = list(cache._ttl_heap)
    port._emb_cache = {k: np.array(v) for k, v in cache._emb_cache.items()}
    port._embs = {k: np.array(v) for k, v in cache._embs.items()}
    if cache._hnsw is not None:
        port._hnsw = hnsw_from_jax(cache._hnsw)
    port._hnsw_keys = list(cache._hnsw_keys)
    port._node_of = dict(cache._node_of)
    port.stats = llm_cache.CacheStats(**asdict(cache.stats))
    return port


def partitioner_from_jax(part, device="cuda"):
    """The port's partitioner of the same class as the JAX ``part``,
    carrying its trained state (module docstring). ``device``: where a
    semantic partitioner trains again if its caller retrains it."""
    from neumann_tpu_torch.parallel import partitioner as tp

    kind = type(part).__name__
    if kind == "SemanticPartitioner":
        port = tp.SemanticPartitioner(part.n_shards, device=device)
        port.centroids = (None if part.centroids is None
                          else np.array(part.centroids, np.float32))
        return port
    if kind == "VoronoiPartitioner":
        return tp.VoronoiPartitioner(np.array(part.seeds, np.float32))
    if kind == "ConsistentHashPartitioner":
        port = tp.ConsistentHashPartitioner.__new__(
            tp.ConsistentHashPartitioner)
        port.virtual_nodes = part.virtual_nodes
        port._ring = list(part._ring)
        port._owner = dict(part._owner)
        port._shards = list(part._shards)
        return port
    raise TypeError(f"no port partitioner for {kind}")


def router_from_files(wal_path, snapshot_path=None, device="cuda"):
    """A port ``QueryRouter`` over the state in a snapshot + WAL."""
    from neumann_tpu_torch.router import QueryRouter

    router = QueryRouter(device=device)
    router.recover(wal_path, snapshot_path=snapshot_path)
    return router


def chain_from_jax(jax_chain, store, device="cuda"):
    """A port ``TensorChain`` over ``store`` carrying a JAX chain's
    state (module docstring); its codebooks train on ``device``."""
    import itertools
    import re

    from neumann_tpu_torch.chain.block import Block
    from neumann_tpu_torch.chain.codebook import (
        GlobalCodebook,
        LocalCodebook,
    )
    from neumann_tpu_torch.chain.consensus import ConsensusConfig
    from neumann_tpu_torch.chain.tensor_chain import TensorChain

    cfg = jax_chain.consensus
    chain = TensorChain(store, jax_chain.embedding_dim,
                        ConsensusConfig(**vars(cfg)),
                        signing_key=jax_chain.chain._key, device=device)
    chain.chain._blocks = [Block(
        height=b.height, prev_hash=b.prev_hash, timestamp=b.timestamp,
        transactions=copy.deepcopy(b.transactions),
        state_root=b.state_root,
        delta_embedding=(None if b.delta_embedding is None
                         else list(b.delta_embedding)),
        signature=b.signature, codebook_code=b.codebook_code)
        for b in jax_chain.chain.blocks()]
    src, dst = jax_chain.codebooks, chain.codebooks
    dst.n_codes, dst.train_after = src.n_codes, src.train_after
    dst._buffer = [(h, np.array(d, np.float32)) for h, d in src._buffer]
    dst.transitions = copy.deepcopy(src.transitions)
    gb = src.global_book
    if gb is not None:
        book = GlobalCodebook(gb.dim, gb.n_codes, device)
        book.codes = None if gb.codes is None else np.array(gb.codes,
                                                           np.float32)
        book._threshold = gb._threshold
        dst.global_book = book
        for domain, lb in src.locals.items():
            local = LocalCodebook(book, lb.ema)
            local.codes = None if lb.codes is None else np.array(
                lb.codes, np.float32)
            local.usage = np.array(lb.usage, np.int64)
            dst.locals[domain] = local
    chain._code_sync = getattr(jax_chain, "_code_sync", 0)
    # itertools.count shows its next value only in its repr
    nxt = int(re.fullmatch(r"count\((\d+)\)", repr(jax_chain._tx_ids))
              .group(1))
    chain._tx_ids = itertools.count(nxt)
    for name in ("commits", "rollbacks", "conflicts_rejected",
                 "auto_merges", "blocks"):
        setattr(chain.metrics, name, getattr(jax_chain.metrics, name))
    return chain



def _shards_of(mesh, axis: str, n_shards: int):
    devices = mesh.axis_devices(axis)
    if len(devices) != n_shards:
        raise ValueError(f"the JAX placement has {n_shards} shards, the "
                         f"mesh {len(devices)} devices along {axis!r}")
    return devices


def sharded_corpus_from_jax(sc, mesh, axis: str = "shard"):
    """A port ``ShardedCorpus`` holding a loaded JAX ``ShardedCorpus``'s
    rows, scales, squared norms and mask, shard i on the i-th device of
    ``mesh`` along ``axis``."""
    import torch

    from neumann_tpu_torch.parallel.sharded_search import ShardedCorpus

    devices = _shards_of(mesh, axis, sc.n_shards)
    out = ShardedCorpus(mesh, sc.dim, axis, quantized=sc.quantized)

    def split(arr):
        parts = np.split(np.asarray(arr), len(devices))
        return [torch.from_numpy(np.array(p)).to(d)
                for p, d in zip(parts, devices)]

    out.corpus = split(sc.corpus)
    if sc.quantized:
        out.scale, out.sqnorm = split(sc.scale), split(sc.sqnorm)
    out._mask_host = np.asarray(sc.mask, bool)
    out.mask = split(out._mask_host)
    out.n_rows = sc.n_rows
    return out


def sharded_ivf_from_jax(ivf, mesh, axis: str = "shard"):
    """A port ``ShardedIVFCorpus`` holding a loaded JAX
    ``ShardedIVFCorpus``'s layout (int8 windows, multipliers, window
    centroids and starts, row ids) and probe settings, shard i on the
    i-th device of ``mesh`` along ``axis``."""
    import torch

    from neumann_tpu_torch.parallel.sharded_search import ShardedIVFCorpus

    devices = _shards_of(mesh, axis, ivf.n_shards)
    out = ShardedIVFCorpus(mesh, ivf.dim, axis, n_clusters=ivf.n_clusters,
                           nprobe=ivf._nprobe_cfg, iters=ivf.iters)

    def split(arr):
        return [torch.from_numpy(np.array(p)).to(d)
                for p, d in zip(np.asarray(arr), devices)]

    out.corpus, out.rmult = split(ivf.corpus), split(ivf.rmult)
    out.cents, out.starts = split(ivf.cents), split(ivf.starts)
    out.row_ids = np.array(ivf.row_ids, np.int64)
    for name in ("rows_s", "window", "c_per", "n_rows", "nprobe"):
        setattr(out, name, int(getattr(ivf, name)))
    return out
