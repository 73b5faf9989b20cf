"""The port's blob storage (neumann_tpu_torch/blob/blob_store.py, a
copy of the JAX package's) and the routers' BLOB and BLOBS statements,
against the JAX package's, on the CPU.

The blob cases of tests/test_extended_modules.py and tests/test_blob.py
(chunking and dedup, the streaming writer, corruption detected by
VERIFY and on read, the id counter recovered from the store) run on
both packages as one test each (tests/torch_twins.py). Then statement
scripts run through a JAX and a port router: equal kind, rows, count,
message and value, errors of the same class; the one field that differs
by nature, an artifact's ``created`` time, is left out. Chunks are
store keys, so a checkpoint holds them: a deleted blob comes back with
ROLLBACK on both.
"""

import pytest

from tests.test_torch_relational import routers, same
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_extended_modules", (
    "test_blob_chunking_and_dedup", "test_blob_streaming_writer",
    "test_blob_verify_detects_corruption", "test_blob_id_counter_recovery")))
globals().update(twin_tests("test_blob"))

BIG = "x" * ((1 << 20) + 300)         # two chunks, the second shared

SCRIPTS = {
    "put_get_info": [
        "BLOB PUT 'a.txt' 'not initialised'",
        "BLOBS",
        "BLOB INIT", "BLOB INIT",
        "BLOB PUT 'a.txt' 'hello world'",
        "BLOB PUT 'b.txt' DATA 'second' TYPE 'text/plain' BY 'ann'",
        f"BLOB PUT 'big.bin' DATA '{BIG}' TYPE 'application/octet-stream'",
        f"BLOB PUT 'big2.bin' DATA '{BIG}y'",
        "BLOB PUT 'c.txt'",
        "BLOB GET 'art-0'", "BLOB GET 'art-2'", "BLOB GET 'art-99'",
        "BLOB INFO 'art-1'", "BLOB INFO 'art-2'", "BLOB INFO 'nope'",
        "BLOB VERIFY 'art-2'", "BLOB VERIFY 'art-3'",
        "BLOB STATS", "BLOBS", "BLOBS '*.txt'",
        "BLOBS WHERE TYPE = 'text/plain'",
        "BLOB DELETE 'art-2'", "BLOB DELETE 'art-2'", "BLOB STATS",
        "BLOB GC", "BLOB GC FULL", "BLOB REPAIR", "BLOB STATS",
        "BLOB VERIFY 'art-3'",
    ],
    "links_tags_meta": [
        "BLOB INIT",
        "BLOB PUT 'r.pdf' 'report' LINK 'user:1' TAG 'q3'",
        "BLOB PUT 's.pdf' 'slides' TAG 'q3'",
        "BLOB PUT 't.csv' 'table' TYPE 'text/csv'",
        "BLOB LINK 'art-1' TO 'user:1'", "BLOB LINK 'art-2' TO 'user:2'",
        "BLOB LINKS 'art-0'", "BLOBS FOR 'user:1'", "BLOBS FOR 'user:9'",
        "BLOB UNLINK 'art-1' FROM 'user:1'", "BLOBS FOR 'user:1'",
        "BLOB TAG 'art-2' 'q4'", "BLOBS BY TAG 'q3'", "BLOBS BY TAG 'q4'",
        "BLOB UNTAG 'art-0' 'q3'", "BLOBS BY TAG 'q3'",
        "BLOB META SET 'art-0' 'owner' 'ann'",
        "BLOB META GET 'art-0' 'owner'", "BLOB META GET 'art-0' 'none'",
        "BLOB META SET 'art-9' 'owner' 'ann'",
        "BLOBS SIMILAR TO 'art-0' LIMIT 5", "BLOBS WHERE TYPE = 'text/csv'",
        "BLOB LINKS 'art-9'",
    ],
}


def both(jr, tr, stmt):
    """``stmt`` on both routers: equal results (rows without their
    ``created`` times) or errors of the same class."""
    try:
        want = jr.execute(stmt)
    except Exception as e:  # noqa: BLE001 — compared below
        with pytest.raises(Exception) as got:
            tr.execute(stmt)
        assert type(got.value).__name__ == type(e).__name__, stmt
        return None
    got = tr.execute(stmt)
    for f in ("kind", "count", "message", "value"):
        same(getattr(want, f), getattr(got, f), path=f"{stmt[:60]!r}.{f}")
    strip = [[{k: v for k, v in r.items() if k != "created"}
              for r in res.rows] for res in (want, got)]
    same(strip[0], strip[1], path=f"{stmt[:60]!r}.rows")
    return got


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_blob_statements_match_jax(script):
    jr, tr = routers()
    for stmt in SCRIPTS[script]:
        both(jr, tr, stmt)


def test_blob_from_and_to_files(tmp_path):
    jr, tr = routers()
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 9000)
    for r, name in ((jr, "jax"), (tr, "port")):
        r.execute("BLOB INIT")
        r.execute(f"BLOB PUT 'in.bin' FROM '{src}'")
        r.execute(f"BLOB GET 'art-0' TO '{tmp_path / name}.out'")
        assert (tmp_path / f"{name}.out").read_bytes() == src.read_bytes()
    both(jr, tr, "BLOB INFO 'art-0'")


def test_a_deleted_blob_comes_back_with_rollback(tmp_path):
    """The chunks are store keys: CHECKPOINT holds them, and after BLOB
    DELETE a ROLLBACK restores the artifact with equal bytes."""
    jr, tr = routers()
    for r, name in ((jr, "jax"), (tr, "port")):
        r.init_checkpoints(str(tmp_path / name))
    for stmt in ("BLOB INIT", f"BLOB PUT 'big.bin' DATA '{BIG}'",
                 "CHECKPOINT 'with_blob'", "BLOB DELETE 'art-0'",
                 "BLOB VERIFY 'art-0'", "BLOB STATS",
                 "ROLLBACK TO 'with_blob'", "BLOB VERIFY 'art-0'",
                 "BLOB STATS"):
        both(jr, tr, stmt)
    assert tr.execute("BLOB GET 'art-0'").value == BIG.encode()
