"""Carry state from the JAX package to the port.

``ivf_state_from_jax(ivf)`` reads a built ``neumann_tpu.ops.ivf.
DeviceIVFInt8`` as host numpy arrays, through ``np.asarray`` only (this
module never imports JAX: the arrays convert themselves).
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

``router_from_files(wal_path, snapshot_path, device)`` gives a port
``QueryRouter`` over a store that the JAX package's router wrote (its
``checkpoint`` snapshot and the WAL after it; both packages write the
same bytes): the engines rebuild tables, nodes, edges and entity
embeddings through their store hooks, and ``QueryRouter.recover``
rebuilds the unified engine's key -> node map from the recovered graph.
"""

from __future__ import annotations

import numpy as np

IVF_STATE_KEYS = ("centroids", "_buf", "_rmult", "_scale", "_rbuf",
                  "_rscale", "_starts", "_row_ids", "_window", "nprobe",
                  "_fixed")


def ivf_state_from_jax(ivf) -> dict:
    """Host copy of a built JAX ``DeviceIVFInt8``'s search state."""
    if getattr(ivf, "_buf", None) is None:
        raise ValueError("the JAX index is not built")
    if getattr(ivf, "_dn", 0) or getattr(ivf, "_deleted", 0):
        raise ValueError("the JAX index has un-compacted adds/deletes; "
                         "the port has no delta plane yet (compact() "
                         "first)")
    state = {}
    for key in IVF_STATE_KEYS:
        value = getattr(ivf, key)
        state[key] = None if value is None else np.asarray(value)
    state["_window"] = int(state["_window"])
    state["nprobe"] = int(state["nprobe"])
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



def router_from_files(wal_path, snapshot_path=None, device="cuda"):
    """A port ``QueryRouter`` over the state in a snapshot + WAL."""
    from neumann_tpu_torch.router import QueryRouter

    router = QueryRouter(device=device)
    router.recover(wal_path, snapshot_path=snapshot_path)
    return router
