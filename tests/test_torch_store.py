"""The port's copy of the host store (``neumann_tpu_torch/store``) against
the JAX package's: the same entities written by one package are read
back by the other, with the same bytes on disk, through the codec, the
write-ahead log, snapshots (plain and compressed) and snapshot bytes;
the entity index hands out the same rows. Each case runs with the native
C codec and with its documented pure-Python fallback.
"""

import numpy as np
import pytest

from neumann_tpu.store import codec as jcodec
from neumann_tpu.store import entity_index as jei
from neumann_tpu.store import sparse as jsparse
from neumann_tpu.store import tensor_store as jts
from neumann_tpu_torch.store import codec as tcodec
from neumann_tpu_torch.store import entity_index as tei
from neumann_tpu_torch.store import sparse as tsparse
from neumann_tpu_torch.store import tensor_store as tts

PACKAGES = {"jax": (jts, jsparse, jcodec), "torch": (tts, tsparse, tcodec)}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


@pytest.fixture(params=["native", "python"])
def codec_mode(request, monkeypatch):
    """Both packages on the C codec, or both on the pure-Python one."""
    if request.param == "python":
        for mod in (jcodec, tcodec):
            monkeypatch.setattr(mod, "_native", lambda: None)
    return request.param


def _entities(pkg: str, n: int = 24, seed: int = 0):
    ts, sp, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        dense = rng.standard_normal(16).astype(np.float32)
        dense[rng.random(16) < 0.7] = 0.0
        td = ts.TensorData()
        td.set("name", ts.TensorValue.scalar(f"row {i}"))
        td.set("n", ts.TensorValue.scalar(int(rng.integers(-1 << 40, 1 << 40))))
        td.set("x", ts.TensorValue.scalar(float(rng.standard_normal())))
        td.set("ok", ts.TensorValue.scalar(bool(i % 2)))
        td.set("emb", ts.TensorValue.vector(rng.standard_normal(8)))
        td.set("sp", ts.TensorValue.sparse(sp.SparseVector.from_dense(dense)))
        td.set("to", ts.TensorValue.pointer(f"k{(i + 1) % n}"))
        td.set("all", ts.TensorValue.pointers([f"k{j}" for j in range(i % 4)]))
        out[f"k{i:03d}"] = td
    return out


def _plain(value):
    """A TensorValue as package-free Python values."""
    v = value.value
    if value.kind == "vector":
        return ("vector", np.asarray(v).tolist())
    if value.kind == "sparse":
        return ("sparse", v.dim, np.asarray(v.positions).tolist(),
                np.asarray(v.values).tolist())
    if value.kind == "pointers":
        return ("pointers", list(v))
    return (value.kind, v)


def _contents(store):
    return {key: {name: _plain(val)
                  for name, val in store.get(key).fields.items()}
            for key in sorted(store.keys())}


def _fill(pkg, store, deletes=True):
    for key, td in _entities(pkg).items():
        store.put(key, td)
    if deletes:
        store.delete("k003")
        store.delete("k011")


def test_codec_same_bytes_both_ways(codec_mode):
    jd, td = _entities("jax"), _entities("torch")
    for key in jd:
        jb, tb = jcodec.encode_data(jd[key]), tcodec.encode_data(td[key])
        assert jb == tb
        back = tcodec.decode_data(jb)
        assert type(back) is tts.TensorData
        assert {n: _plain(v) for n, v in back.fields.items()} == \
            {n: _plain(v) for n, v in jd[key].fields.items()}
        assert {n: _plain(v) for n, v in jcodec.decode_data(tb).fields.items()} \
            == {n: _plain(v) for n, v in td[key].fields.items()}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_wal_same_bytes_and_replay_across(tmp_path, codec_mode, writer,
                                          reader):
    paths = {}
    for pkg in ("jax", "torch"):
        store = PACKAGES[pkg][0].TensorStore()
        paths[pkg] = tmp_path / f"{pkg}.wal"
        store.open_durable(paths[pkg], sync_mode="immediate")
        _fill(pkg, store)
        store.wal_flush()
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    want = PACKAGES[writer][0].TensorStore()
    _fill(writer, want)
    got = PACKAGES[reader][0].TensorStore()
    assert got.recover(paths[writer]) > 0
    assert _contents(got) == _contents(want)
    assert type(got.get("k000")).__module__.startswith(
        PACKAGES[reader][0].__name__)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_snapshot_same_bytes_and_load_across(tmp_path, codec_mode, writer,
                                             reader, compressed):
    stores = {}
    for pkg in ("jax", "torch"):
        stores[pkg] = PACKAGES[pkg][0].TensorStore()
        _fill(pkg, stores[pkg])
        stores[pkg].save_snapshot(tmp_path / f"{pkg}.snap",
                                  compressed=compressed)
    assert (tmp_path / "jax.snap").read_bytes() == \
        (tmp_path / "torch.snap").read_bytes()
    got = PACKAGES[reader][0].TensorStore()
    got.load_snapshot(tmp_path / f"{writer}.snap")
    assert _contents(got) == _contents(stores[writer])
    blob = stores[writer].snapshot_bytes()
    assert blob == stores[reader].snapshot_bytes()
    again = PACKAGES[reader][0].TensorStore()
    again.restore_from_bytes(blob)
    assert _contents(again) == _contents(stores[writer])


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_checkpoint_then_wal_recovers_across(tmp_path, codec_mode, writer,
                                             reader):
    """Snapshot + WAL tail written by one package, recovered by the
    other: the state after both is the writer's."""
    ts = PACKAGES[writer][0]
    store = ts.TensorStore()
    store.open_durable(tmp_path / "w.wal", sync_mode="immediate")
    _fill(writer, store, deletes=False)
    store.checkpoint(tmp_path / "w.snap")
    store.delete("k005")
    store.put("late", ts.TensorData().set("v", ts.TensorValue.scalar(7)))
    store.wal_flush()
    got = PACKAGES[reader][0].TensorStore()
    got.recover(tmp_path / "w.wal", snapshot_path=tmp_path / "w.snap")
    assert _contents(got) == _contents(store)
    assert not got.exists("k005") and got.get("late").get("v").value == 7


def test_entity_index_same_rows():
    rng = np.random.default_rng(3)
    j, t = jei.EntityIndex(), tei.EntityIndex()
    for step in range(4):
        keys = [f"e{int(x)}" for x in rng.integers(0, 300, 200)]
        np.testing.assert_array_equal(t.get_or_insert_many(keys),
                                      j.get_or_insert_many(keys))
        key = f"single{step}"
        assert t.get_or_insert(key) == j.get_or_insert(key)
    for key in ("e5", "single2", "absent"):
        assert t.lookup(key) == j.lookup(key)
