"""The port's graph engine, graph algorithms and Cypher
(neumann_tpu_torch/engines/graph.py, graph_algorithms.py, lang/cypher.py
and the router's graph statements) against the JAX package's, on the
CPU.

Scripts run statement by statement through both routers
(``test_torch_relational.run_both``): kind, rows, count, message and
value equal. The host code is a copy in the port, so traversal, paths,
patterns, constraints and the host algorithms (betweenness, closeness,
Louvain, label propagation) must agree exactly. The device analytics
run on torch in the port: component labels and BFS levels exactly,
PageRank within rtol 1e-5 and eigenvector centrality within rtol 1e-4
(floats summed in another order), each compared per node id so that
near-ties may swap places in the ranked rows. Eigenvector centrality is
a float32 unit vector: components of nodes outside the dominant
component decay towards 0 and end as round-off (1e-13 against 6e-13
in one run), so they are held to an absolute 1e-6 instead.
"""

import numpy as np
import pytest

from tests.test_torch_relational import routers, run_both, same

GRAPH_SCRIPTS = {
    "crud_and_lookups": [
        "NODE CREATE person { name: 'Alice', age: 30 }",
        "NODE CREATE person { name: 'Bob', age: 25 }",
        "NODE CREATE city { name: 'Rome' }",
        "EDGE CREATE 0 -> 1 : knows { since: 2020 }",
        "EDGE CREATE 1 -> 0 : knows",
        "EDGE CREATE 0 -> 2 : lives_in",
        "NODE GET 0",
        "NODE GET 4242",
        "NODE GET 'not-an-int'",
        "NODE LIST person",
        "NODE LIST",
        "EDGE GET 0",
        "EDGE GET 9999",
        "EDGE LIST knows",
        "EDGE LIST LIMIT 1 OFFSET 1",
        "NEIGHBORS 0 OUTGOING : knows",
        "NEIGHBORS 0 BOTH",
        "NEIGHBORS 0 INCOMING",
        "DESCRIBE NODE person",
        "DESCRIBE EDGE knows",
        "FIND NODE person WHERE age > 26",
        "FIND NODE person RETURN name AS who, age LIMIT 5",
        "FIND EDGE knows",
        "FIND EDGE WHERE since > 2019",
        "FIND PATH person -[knows]-> person",
        "FIND PATH person -[]-> city",
        "FIND PATH -[lives_in]-> city",
        "GRAPH AGGREGATE COUNT NODES person",
        "GRAPH AGGREGATE COUNT EDGES knows",
        "GRAPH AGGREGATE AVG NODE age person",
        "GRAPH AGGREGATE SUM EDGE since",
        "EDGE DELETE 1",
        "NODE DELETE 2",
        "GRAPH AGGREGATE COUNT EDGES",
        "EDGE CREATE 0 -> 77 : knows",
    ],
    "paths": [
        "GRAPH BATCH CREATE NODES [(p { n: 'a' }), (p { n: 'b' }), "
        "(p { n: 'c' }), (p { n: 'd' }), (p { n: 'e' })]",
        "GRAPH BATCH CREATE EDGES [(0 -> 1 : r), (1 -> 2 : r), "
        "(2 -> 3 : r), (0 -> 3 : s), (3 -> 4 : r)]",
        "EDGE CREATE 1 -> 3 : r { cost: 5 }",
        "EDGE CREATE 0 -> 2 : r { cost: 1 }",
        "PATH SHORTEST 0 TO 4",
        "PATH SHORTEST 4 TO 0",
        "PATH WEIGHTED 0 TO 4 WEIGHT cost",
        "PATH ALL 0 TO 4 MAX_DEPTH 4",
        "PATH ALL 0 TO 4 MIN_DEPTH 3 MAX_DEPTH 4",
        "PATH VARIABLE 0 TO 3 MIN_DEPTH 1 MAX_DEPTH 3",
        "GRAPH BATCH UPDATE NODES [(0 { age: 31 })]",
        "NODE GET 0",
        "GRAPH BATCH DELETE EDGES [0, 1]",
        "PATH SHORTEST 0 TO 2",
        "GRAPH BATCH DELETE NODES [3]",
        "PATH SHORTEST 0 TO 4",
    ],
    "constraints_indexes_patterns": [
        "GRAPH CONSTRAINT CREATE uniq_email ON NODE (user) email UNIQUE",
        "NODE CREATE user { email: 'a@x.com' }",
        "NODE CREATE user { email: 'a@x.com' }",
        "GRAPH CONSTRAINT CREATE needs_name ON NODE name EXISTS",
        "NODE CREATE person { age: 3 }",
        "GRAPH CONSTRAINT LIST",
        "GRAPH CONSTRAINT GET uniq_email",
        "GRAPH CONSTRAINT DROP needs_name",
        "NODE CREATE person { age: 3 }",
        "NODE CREATE person { name: 'a', city: 'SF' }",
        "NODE CREATE person { name: 'b', city: 'LA' }",
        "GRAPH INDEX CREATE NODE PROPERTY city",
        "GRAPH INDEX SHOW NODE",
        "FIND NODE person WHERE city = 'SF'",
        "GRAPH INDEX DROP NODE city",
        "GRAPH INDEX CREATE LABEL",
        "EDGE CREATE 2 -> 3 : reports_to",
        "GRAPH PATTERN COUNT (x:person)-[:reports_to]->(y:person)",
        "GRAPH PATTERN EXISTS (x:person)-[:mentors]->(y:person)",
        "GRAPH PATTERN MATCH (x:person)-[:reports_to]->(y:person) LIMIT 5",
    ],
    "cypher": [
        "CREATE (a:Person { name: 'Alice', age: 34 })",
        "CREATE (b:Person { name: 'Bob', age: 28 })",
        "CREATE (c:Person { name: 'Carol', age: 41 })",
        "MATCH (a:Person { name: 'Alice' }), (b:Person { name: 'Bob' }) "
        "CREATE (a)-[:KNOWS { since: 2020 }]->(b)",
        "MATCH (b:Person { name: 'Bob' }), (c:Person { name: 'Carol' }) "
        "CREATE (b)-[:KNOWS]->(c)",
        "MATCH (p:Person) RETURN p.name ORDER BY p.name",
        "MATCH (p:Person) WHERE p.age > 30 RETURN p.name, p.age "
        "ORDER BY p.age DESC",
        "MATCH (p:Person) RETURN p.name SKIP 1 LIMIT 1",
        "MATCH (p:Person) RETURN COUNT(*) AS n",
        "MATCH (a)-[:KNOWS]->(b) RETURN a.name, b.name",
        "MATCH (a)-[:KNOWS*1..2]->(b) RETURN a.name, b.name",
        "MATCH (x)<-[:KNOWS]-(y) RETURN x.name",
        "MATCH (x { name: 'Bob' })-[:KNOWS]-(y) RETURN y.name",
        "MATCH (p:Person { name: 'Bob' }) SET p.age = 29",
        "MATCH (p:Person { name: 'Bob' }) RETURN p.age",
        "MERGE (p:Person { name: 'Zed' }) ON CREATE SET p.age = 1",
        "MERGE (p:Person { name: 'Zed' }) ON MATCH SET p.age = 2",
        "MATCH (p:Person { name: 'Zed' }) RETURN p.age",
        "MATCH (p:Person { name: 'Alice' }) DELETE p",
        "MATCH (p:Person { name: 'Alice' }) DETACH DELETE p",
        "MATCH (p:Person) RETURN p.name ORDER BY p.name",
        "MATCH (p:Person RETURN p",
    ],
}


@pytest.mark.parametrize("script", sorted(GRAPH_SCRIPTS))
def test_graph_script(script):
    jr, tr = routers()
    for stmt in GRAPH_SCRIPTS[script]:
        run_both(jr, tr, stmt)


def _random_graph(jr, tr, seed, n=40, m=90):
    """The same seeded graph through both routers: a few components, a
    self-loop, some undirected edges, weights for the paths."""
    rng = np.random.default_rng(seed)
    stmts = [f"NODE CREATE n {{ i: {i} }}" for i in range(n)]
    for _ in range(m):
        a, b = (int(x) for x in rng.integers(0, n - 6, 2))
        stmts.append(f"EDGE CREATE {a} -> {b} : e "
                     f"{{ weight: {int(rng.integers(1, 9))} }}")
    stmts += [f"EDGE CREATE {n - 5} -> {n - 4} : e",
              f"EDGE CREATE {n - 3} -> {n - 3} : e",
              f"NODE DELETE {n - 1}"]
    for stmt in stmts:
        run_both(jr, tr, stmt)
    for _ in range(6):
        a, b = (int(x) for x in rng.integers(0, n - 6, 2))
        jr.graph.create_edge(a, b, "u", directed=False)
        tr.graph.create_edge(a, b, "u", directed=False)


def _by_id(rows, key):
    return {r["id"]: r[key] for r in rows}


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_analytics(seed):
    jr, tr = routers()
    _random_graph(jr, tr, seed)
    for stmt in ("PAGERANK", "PAGERANK DAMPING 0.9 MAX_ITERATIONS 50",
                 "GRAPH PAGERANK DAMPING 0.85 ITERATIONS 30"):
        want, got = jr.execute(stmt).rows, tr.execute(stmt).rows
        same(_by_id(want, "rank"), _by_id(got, "rank"), rtol=1e-5,
             path=stmt)
    for stmt in ("EIGENVECTOR MAX_ITERATIONS 30",
                 "GRAPH EIGENVECTOR CENTRALITY ITERATIONS 50 "
                 "TOLERANCE 0.001"):
        want, got = jr.execute(stmt).rows, tr.execute(stmt).rows
        same(_by_id(want, "centrality"), _by_id(got, "centrality"),
             rtol=1e-4, path=stmt, atol=1e-6)
    for stmt in ("BETWEENNESS SAMPLING_RATIO 1.0", "CLOSENESS",
                 "GRAPH CLOSENESS CENTRALITY INCOMING",
                 "LOUVAIN RESOLUTION 1.0",
                 "LABEL_PROPAGATION MAX_ITERATIONS 10",
                 "PATH WEIGHTED 0 TO 7 WEIGHT weight",
                 "PATH SHORTEST 3 TO 11"):
        run_both(jr, tr, stmt)
    same(jr.graph.connected_components(), tr.graph.connected_components())
    for start in (0, 5):
        for depth in (0, 2):
            for direction in ("out", "both"):
                same(jr.graph.bfs_levels(start, depth, direction),
                     tr.graph.bfs_levels(start, depth, direction))


def test_graph_analytics_of_an_empty_graph():
    """No nodes: the dummy self-loop gives both packages empty maps; one
    node and no edges: rank 1, its own component, level 0."""
    jr, tr = routers()
    for eng in (jr.graph, tr.graph):
        assert eng.pagerank() == {} and eng.connected_components() == {}
    run_both(jr, tr, "NODE CREATE n { }")
    same(jr.graph.pagerank(), tr.graph.pagerank(), rtol=1e-6)
    same(jr.graph.connected_components(), tr.graph.connected_components())
    same(jr.graph.bfs_levels(0), tr.graph.bfs_levels(0))
    same(jr.graph.eigenvector_centrality(),
         tr.graph.eigenvector_centrality(), rtol=1e-4, atol=1e-6)


def test_edge_tensors_follow_the_graph():
    """The cached device edge list is rebuilt after every node or edge
    change, as the JAX engine's is."""
    jr, tr = routers()
    for stmt in ("NODE CREATE n { }", "NODE CREATE n { }",
                 "NODE CREATE n { }", "EDGE CREATE 0 -> 1 : e"):
        run_both(jr, tr, stmt)
    assert tr.graph.connected_components() == {0: 0, 1: 0, 2: 2}
    run_both(jr, tr, "EDGE CREATE 1 -> 2 : e")
    assert tr.graph.connected_components() == {0: 0, 1: 0, 2: 0}
    run_both(jr, tr, "EDGE DELETE 0")
    same(jr.graph.connected_components(), tr.graph.connected_components())
    assert tr.graph.bfs_levels(0) == {0: 0}
    src, *_ = tr.graph._edge_arrays()
    assert src.dtype.is_floating_point is False and src.dtype.itemsize == 8
