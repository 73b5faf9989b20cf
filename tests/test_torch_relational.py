"""The port's relational engine and SQL statements
(neumann_tpu_torch/engines/relational.py, router/router.py) against the
JAX package's, on the CPU.

Each script runs statement by statement through a fresh JAX
``QueryRouter`` and a fresh port ``QueryRouter(device="cpu")``. Every
``QueryResult`` must agree in kind, rows, count, message and value; a
statement that raises on one side must raise the same error class on
the other. The relational engine is host code in both packages (the
port's is a copy), so values are compared exactly. The statements are
drawn from tests/test_router.py, test_sql_*.py and test_relational.py.

``run_both`` and ``same`` are shared with test_torch_graph.py and
test_torch_unified.py.
"""

import math

import numpy as np
import pytest

from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.utils.errors import NeumannError


def routers():
    jr = JRouter()
    # tests/conftest.py gives JAX 8 virtual CPU devices: keep its
    # corpora off the mesh, as one card has none
    jr.vector.config = JConfig(mesh_auto=False)
    return jr, TRouter(device="cpu")


def same(a, b, rtol=0.0, path="result", atol=0.0):
    """Deep equality; floats within ``rtol`` / ``atol`` (exact at 0),
    numpy scalars and arrays compared by value."""
    if isinstance(a, np.generic):
        a = a.item()
    if isinstance(b, np.generic):
        b = b.item()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            f"{path}: {a!r} != {b!r}"
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), f"{path}: {a} != {b}"
        else:
            assert math.isclose(a, b, rel_tol=rtol, abs_tol=atol) \
                or a == b, f"{path}: {a!r} != {b!r}"
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            same(a[k], b[k], rtol, f"{path}[{k!r}]", atol)
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), \
            f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, rtol, f"{path}[{i}]", atol)
        return
    assert a == b, f"{path}: {a!r} != {b!r}"


def run_both(jr, tr, stmt, rtol=0.0, fields=("kind", "rows", "count",
                                             "message", "value",
                                             "results")):
    """Execute ``stmt`` on both routers and hold the results equal;
    returns the port's result (None if both raised)."""
    try:
        want = jr.execute(stmt)
    except Exception as e:  # noqa: BLE001 — compared below
        with pytest.raises(Exception) as got:
            tr.execute(stmt)
        assert type(got.value).__name__ == type(e).__name__, stmt
        return None
    got = tr.execute(stmt)
    for f in fields:
        same(getattr(want, f), getattr(got, f), rtol, f"{stmt!r}.{f}")
    return got


SCRIPTS = {
    "create_insert_select": [
        "CREATE TABLE users (id INT PRIMARY KEY, name TEXT, age INT)",
        "CREATE TABLE IF NOT EXISTS users (a INT)",
        "INSERT INTO users VALUES (1, 'Alice', 30), (2, 'Bob', 25), "
        "(3, 'Carol', 41)",
        "INSERT INTO users (id, name) VALUES (4, 'Dan')",
        "INSERT INTO users VALUES (5, 'Eve', 40)",
        "SELECT * FROM users",
        "SELECT name, age FROM users WHERE age > 26",
        "SELECT * FROM users WHERE age IS NULL",
        "SELECT * FROM users WHERE name LIKE 'A%'",
        "SELECT * FROM users WHERE age BETWEEN 25 AND 40",
        "SELECT * FROM users WHERE id IN (1, 3, 9)",
        "SELECT * FROM users WHERE id NOT IN (1, 2)",
        "SELECT * FROM users WHERE age > 26 AND NOT name = 'Eve' "
        "OR id = 4",
        "SELECT * FROM users ORDER BY age DESC LIMIT 2 OFFSET 1",
        "SELECT * FROM users ORDER BY name LIMIT -1",
        "SELECT * FROM users LIMIT 0",
        "SELECT * FROM missing_table",
        "INSERT INTO users VALUES (1, 'dup', 1)",
        "INSERT INTO users (id, name) VALUES (1)",
        "SHOW TABLES",
        "DESCRIBE TABLE users",
    ],
    "aggregates_and_groups": [
        "CREATE TABLE dd (id INT, g INT, v FLOAT, tag TEXT)",
        "INSERT INTO dd VALUES (0, 0, 1.5, 'a'), (1, 1, 2.5, 'b'), "
        "(2, 2, 2.5, 'a'), (3, 3, NULL, 'c'), (4, 0, 7.25, 'b'), "
        "(5, 1, 1.5, NULL)",
        "SELECT COUNT(*) FROM dd",
        "SELECT COUNT(v) FROM dd",
        "SELECT COUNT(DISTINCT g) FROM dd WHERE v > 2",
        "SELECT SUM(v), AVG(v), MIN(v), MAX(v) FROM dd",
        "SELECT AVG(DISTINCT v) FROM dd",
        "SELECT MIN(DISTINCT v), MAX(DISTINCT v) FROM dd",
        "SELECT COUNT(DISTINCT tag) FROM dd",
        "SELECT g, SUM(v) AS total FROM dd GROUP BY g",
        "SELECT g, COUNT(*) AS n FROM dd GROUP BY g HAVING n > 1",
        "SELECT tag, COUNT(*) FROM dd GROUP BY tag HAVING COUNT(*) > 1 "
        "ORDER BY tag",
        "SELECT g, MAX(v) AS m FROM dd GROUP BY g ORDER BY m DESC "
        "LIMIT 2",
        "SELECT SUM(tag) FROM dd",
    ],
    "joins": [
        "CREATE TABLE a (k INT, x TEXT)",
        "CREATE TABLE b (k INT, y TEXT)",
        "INSERT INTO a VALUES (1, 'a1'), (2, 'a2'), (3, 'a3')",
        "INSERT INTO b VALUES (2, 'b2'), (3, 'b3'), (4, 'b4')",
        "SELECT * FROM a INNER JOIN b ON a.k = b.k",
        "SELECT * FROM a LEFT JOIN b ON a.k = b.k",
        "SELECT * FROM a RIGHT OUTER JOIN b ON a.k = b.k",
        "SELECT * FROM a FULL OUTER JOIN b ON a.k = b.k",
        "SELECT * FROM a CROSS JOIN b",
        "SELECT * FROM a NATURAL JOIN b",
        "SELECT * FROM a JOIN b ON a.k = b.k WHERE b.y = 'b3'",
        "SELECT COUNT(*) FROM a JOIN b ON a.k = b.k",
        "SELECT a.x, b.y FROM a JOIN b ON a.k = b.k ORDER BY b.y DESC",
        "CREATE TABLE a2 (k INT, v INT)",
        "CREATE TABLE b2 (k INT, v INT)",
        "INSERT INTO a2 VALUES (1, 10), (1, 20)",
        "INSERT INTO b2 VALUES (1, 10), (1, 99)",
        "SELECT * FROM a2 JOIN b2 USING (k, v)",
    ],
    "subqueries_and_expressions": [
        "CREATE TABLE users (id INT PRIMARY KEY, name TEXT, age INT)",
        "CREATE TABLE orders (id INT PRIMARY KEY, user_id INT, amt FLOAT)",
        "INSERT INTO users VALUES (1, 'Alice', 30), (2, 'Bob', 25), "
        "(3, 'Carol', 41)",
        "INSERT INTO orders VALUES (1, 1, 120.0), (2, 1, 30.5), "
        "(3, 3, 9.75)",
        "SELECT * FROM users WHERE id IN (SELECT user_id FROM orders)",
        "SELECT * FROM users WHERE EXISTS (SELECT id FROM orders "
        "WHERE amt > 100)",
        "SELECT * FROM users WHERE NOT EXISTS (SELECT id FROM orders "
        "WHERE amt > 1000)",
        "SELECT * FROM users WHERE age > (SELECT MIN(age) FROM users)",
        "SELECT (id + 1) * 2 FROM users",
        "SELECT CASE WHEN age > 28 THEN 'old' ELSE 'young' END AS c "
        "FROM users",
        "SELECT CAST(id AS TEXT) AS sid FROM users ORDER BY sid",
        "SELECT UPPER(name), LOWER(name), LENGTH(name) FROM users",
        "SELECT DISTINCT age FROM users",
        "SELECT name AS who FROM users ORDER BY who DESC",
    ],
    "update_delete_index": [
        "CREATE TABLE t (a INT, b INT, c TEXT)",
        "INSERT INTO t VALUES (1, 2, 'x'), (3, 1, 'y'), (5, 5, 'z'), "
        "(7, 9, 'w'), (9, 3, NULL)",
        "CREATE INDEX ON t (a)",
        "CREATE BTREE INDEX ON t (b)",
        "SELECT * FROM t WHERE a = 5",
        "SELECT * FROM t WHERE b > 2 ORDER BY b",
        "UPDATE t SET c = 'q' WHERE a > 4",
        "UPDATE t SET b = b + 10 WHERE c = 'x'",
        "SELECT * FROM t",
        "DELETE FROM t WHERE a + b > 14",
        "DELETE FROM t WHERE c IS NULL",
        "SELECT * FROM t WHERE b >= 1",
        "DROP INDEX ON t (a)",
        "SELECT * FROM t WHERE a = 5",
        "DELETE FROM t",
        "SELECT COUNT(*) FROM t",
        "DROP TABLE t",
        "DROP TABLE IF EXISTS t",
        "SHOW TABLES",
    ],
    "constraints_and_insert_select": [
        "CREATE TABLE users (id INT PRIMARY KEY, name TEXT NOT NULL, "
        "email TEXT UNIQUE)",
        "CREATE TABLE c (v INT CHECK(v > 0), w INT)",
        "INSERT INTO users VALUES (1, 'a', 'a@x'), (2, 'b', 'b@x')",
        "INSERT INTO users VALUES (3, 'c', 'a@x')",
        "INSERT INTO users VALUES (4, NULL, 'd@x')",
        "INSERT INTO c VALUES (5, 50)",
        "INSERT INTO c VALUES (-1, 50)",
        "CREATE TABLE src (a INT, b TEXT)",
        "CREATE TABLE dst (a INT, b TEXT)",
        "INSERT INTO src VALUES (1, 'x'), (2, 'y')",
        "INSERT INTO dst SELECT a, b FROM src",
        "INSERT INTO dst (a, b) SELECT a, b FROM src WHERE a > 1",
        "SELECT * FROM dst",
        "FIND ROWS FROM dst WHERE a > 1 LIMIT 5",
        "DESCRIBE TABLE users",
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_sql_script(script):
    jr, tr = routers()
    for stmt in SCRIPTS[script]:
        run_both(jr, tr, stmt)


def test_execute_many_and_pagination():
    jr, tr = routers()
    for r in (jr, tr):
        r.execute("CREATE TABLE t (v INT)")
        r.execute("INSERT INTO t VALUES " + ", ".join(
            f"({i})" for i in range(23)))
    many = "INSERT INTO t VALUES (100); SELECT * FROM t WHERE v > 20"
    for want, got in zip(jr.execute_many(many), tr.execute_many(many)):
        same(want.rows, got.rows)
        same(want.count, got.count)
    pages = {}
    for name, r in (("jax", jr), ("port", tr)):
        rows, cur = r.execute_paginated("SELECT * FROM t", 10)
        out = [rows]
        while cur is not None:
            rows, cur = r.execute_paginated("SELECT * FROM t", 10, cur)
            out.append(rows)
        pages[name] = out
    same(pages["jax"], pages["port"])
    assert [len(p) for p in pages["port"]] == [10, 10, 4]


def test_expired_and_closed_cursors_raise():
    _, tr = routers()
    tr.execute("CREATE TABLE t (v INT)")
    tr.execute("INSERT INTO t VALUES (1), (2), (3)")
    _, cur = tr.execute_paginated("SELECT * FROM t", 1, ttl=0.0)
    with pytest.raises(NeumannError):
        tr.execute_paginated("SELECT * FROM t", 1, cur)
    _, cur = tr.execute_paginated("SELECT * FROM t", 1)
    assert tr.close_cursor(cur)
    with pytest.raises(NeumannError):
        tr.execute_paginated("SELECT * FROM t", 1, cur)
