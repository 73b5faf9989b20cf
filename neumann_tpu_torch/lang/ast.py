"""AST node types for the query language.

Statement variants parallel StatementKind (neumann_parser/src/ast.rs:33-143);
conditions reuse the engine Condition tree directly so the router passes
them straight to the engines.

Copy of ``neumann_tpu.lang.ast`` with only its import lines changed
(see ``neumann_tpu_torch.lang.parser`` for why).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.engines.condition import Condition


@dataclass(slots=True)
class Statement:
    """Base class; `kind` is the class name for quick dispatch."""

    @property
    def kind(self) -> str:
        return type(self).__name__


# === SQL ===================================================================

@dataclass(slots=True)
class ColumnDef(Statement):
    name: str
    ctype: str
    nullable: bool = True
    unique: bool = False
    primary_key: bool = False
    default: object = None
    # table, col, on_delete action, on_update action
    references: Optional[Tuple[str, str, str, str]] = None
    check: Optional[Condition] = None


@dataclass(slots=True)
class CreateTable(Statement):
    table: str
    columns: List[ColumnDef] = field(default_factory=list)
    if_not_exists: bool = False
    checks: List[Condition] = field(default_factory=list)
    # composite UNIQUE / PRIMARY KEY column groups (table constraints)
    uniques: List[List[str]] = field(default_factory=list)


@dataclass(slots=True)
class Subquery:
    """A (SELECT ...) appearing as a value inside a condition
    (IN / EXISTS / scalar comparison). The router resolves these to
    concrete values before handing conditions to the engines."""

    select: "Select"


@dataclass(slots=True)
class DropTable(Statement):
    table: str
    if_exists: bool = False


@dataclass(slots=True)
class CreateIndex(Statement):
    table: str
    columns: List[str] = field(default_factory=list)
    name: Optional[str] = None
    unique: bool = False
    btree: bool = False


@dataclass(slots=True)
class DropIndex(Statement):
    name: Optional[str] = None
    table: Optional[str] = None
    column: Optional[str] = None
    if_exists: bool = False


@dataclass(slots=True)
class Insert(Statement):
    table: str
    columns: Optional[List[str]] = None
    rows: List[List[object]] = field(default_factory=list)
    select: Optional["Select"] = None   # INSERT INTO t ... SELECT ...


@dataclass(slots=True)
class SelectItem(Statement):
    expr: str                 # column name, * or aggregate fn name
    agg: Optional[str] = None  # count/sum/avg/min/max
    alias: Optional[str] = None
    # scalar expression tree (lang.expr.Expr) for computed items:
    # arithmetic / CASE / CAST; None for plain columns and aggregates
    tree: Optional[object] = None
    # COUNT(DISTINCT col) etc. — keep LAST: the native parser fills
    # slots positionally (parser_ext.cpp make_obj)
    distinct: bool = False


@dataclass(slots=True)
class JoinClause(Statement):
    table: str
    how: str                 # inner/left/right/full/cross/natural
    left_col: Optional[str] = None
    right_col: Optional[str] = None
    using: Optional[List[str]] = None   # JOIN ... USING (cols)


@dataclass(slots=True)
class Select(Statement):
    table: str
    items: List[SelectItem] = field(default_factory=list)
    where: Optional[Condition] = None
    joins: List[JoinClause] = field(default_factory=list)
    group_by: List[str] = field(default_factory=list)
    having: Optional[Condition] = None
    # (col, desc) or (col, desc, nulls_first); 2-tuples keep the SQL
    # default placement (NULLS LAST asc / NULLS FIRST desc)
    order_by: List[Tuple] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False


@dataclass(slots=True)
class Update(Statement):
    table: str
    updates: Dict[str, object] = field(default_factory=dict)
    where: Optional[Condition] = None


@dataclass(slots=True)
class Delete(Statement):
    table: str
    where: Optional[Condition] = None


@dataclass(slots=True)
class ShowTables(Statement):
    pass


@dataclass(slots=True)
class Describe(Statement):
    target: str               # "table" | "node" | "edge"
    name: str = ""


# === graph =================================================================

@dataclass(slots=True)
class NodeCreate(Statement):
    label: str
    properties: Dict[str, object] = field(default_factory=dict)


@dataclass(slots=True)
class NodeGet(Statement):
    node_id: object = None


@dataclass(slots=True)
class NodeDelete(Statement):
    node_id: object = None


@dataclass(slots=True)
class NodeList(Statement):
    label: Optional[str] = None
    limit: Optional[int] = None
    offset: int = 0


@dataclass(slots=True)
class EdgeCreate(Statement):
    src: object = None
    dst: object = None
    edge_type: str = ""
    properties: Dict[str, object] = field(default_factory=dict)


@dataclass(slots=True)
class EdgeGet(Statement):
    edge_id: object = None


@dataclass(slots=True)
class EdgeDelete(Statement):
    edge_id: object = None


@dataclass(slots=True)
class EdgeList(Statement):
    edge_type: Optional[str] = None
    limit: Optional[int] = None
    offset: int = 0


@dataclass(slots=True)
class Neighbors(Statement):
    node_id: object = None
    direction: str = "out"    # out/in/both
    edge_type: Optional[str] = None
    by_similarity: Optional[List[float]] = None
    limit: Optional[int] = None


@dataclass(slots=True)
class Path(Statement):
    mode: str = "shortest"    # shortest/all/weighted/variable
    src: object = None
    dst: object = None
    max_depth: Optional[int] = None
    min_depth: Optional[int] = None
    weight: Optional[str] = None


@dataclass(slots=True)
class PageRank(Statement):
    damping: float = 0.85
    max_iterations: int = 20


@dataclass(slots=True)
class GraphAlgorithm(Statement):
    name: str = ""            # betweenness/closeness/eigenvector/louvain/
    #                           label_propagation
    params: Dict[str, object] = field(default_factory=dict)


@dataclass(slots=True)
class GraphConstraint(Statement):
    action: str = "create"     # create/drop/list/get
    name: Optional[str] = None
    target: str = "node"
    label: Optional[str] = None
    prop: Optional[str] = None
    kind: str = "unique"       # unique/exists/type
    vtype: Optional[str] = None   # TYPE constraints: required value type


@dataclass(slots=True)
class GraphIndex(Statement):
    action: str = "create"     # create/drop/show
    target: str = "node"
    prop: Optional[str] = None


@dataclass(slots=True)
class GraphPattern(Statement):
    mode: str = "match"        # match/count/exists
    pattern: str = ""
    limit: Optional[int] = None


@dataclass(slots=True)
class GraphBatch(Statement):
    action: str = "create_nodes"
    items: List[object] = field(default_factory=list)


@dataclass(slots=True)
class GraphAggregate(Statement):
    func: str = "count"       # count/sum/avg/min/max
    target: str = "nodes"     # nodes/edges
    prop: Optional[str] = None
    label: Optional[str] = None
    where: Optional[Condition] = None


# === vector ================================================================

@dataclass(slots=True)
class EmbedStore(Statement):
    key: str = ""
    vector: List[float] = field(default_factory=list)
    collection: Optional[str] = None


@dataclass(slots=True)
class EmbedGet(Statement):
    key: str = ""
    collection: Optional[str] = None


@dataclass(slots=True)
class EmbedDelete(Statement):
    key: str = ""
    collection: Optional[str] = None


@dataclass(slots=True)
class EmbedBatch(Statement):
    items: List[Tuple[str, List[float]]] = field(default_factory=list)
    collection: Optional[str] = None


@dataclass(slots=True)
class Similar(Statement):
    """SIMILAR key|[vec] [TOP n|LIMIT n] [METRIC m] [CONNECTED TO id]
    [IN collection] [WHERE cond]  (ast.rs:713-726 parity)."""

    query_key: Optional[str] = None
    query_vector: Optional[List[float]] = None
    limit: int = 10
    metric: Optional[str] = None
    connected_to: Optional[str] = None
    collection: Optional[str] = None
    where: Optional[Condition] = None


@dataclass(slots=True)
class ShowEmbeddings(Statement):
    limit: Optional[int] = None


@dataclass(slots=True)
class CountEmbeddings(Statement):
    pass


@dataclass(slots=True)
class ShowCollections(Statement):
    pass


@dataclass(slots=True)
class CreateCollection(Statement):
    name: str = ""
    dimension: Optional[int] = None
    metric: str = "cosine"
    quantization: str = "none"


@dataclass(slots=True)
class DropCollection(Statement):
    name: str = ""


# === unified ================================================================

@dataclass(slots=True)
class EntityCreate(Statement):
    key: str = ""
    properties: Dict[str, object] = field(default_factory=dict)
    embedding: Optional[List[float]] = None
    update: bool = False


@dataclass(slots=True)
class EntityGet(Statement):
    key: str = ""


@dataclass(slots=True)
class EntityDelete(Statement):
    key: str = ""


@dataclass(slots=True)
class EntityConnect(Statement):
    src: str = ""
    dst: str = ""
    edge_type: str = "related"


@dataclass(slots=True)
class EntityBatchCreate(Statement):
    """ENTITY BATCH CREATE [{key: 'k1', props...}, ...]"""

    items: List[Dict[str, object]] = field(default_factory=list)


@dataclass(slots=True)
class Find(Statement):
    target: str = "node"      # node/edge/rows/path
    label: Optional[str] = None    # label / edge type / table
    where: Optional[Condition] = None
    similar_to: Optional[object] = None   # key or vector
    connected_to: Optional[str] = None
    limit: Optional[int] = None
    # RETURN projection: list of (column, alias) pairs (ast.rs:755-764)
    return_items: Optional[list] = None
    # FIND PATH from -[edge]-> to (each part optional)
    path_from: Optional[str] = None
    path_edge: Optional[str] = None
    path_to: Optional[str] = None


# === vault / cache / blob / checkpoint / chain / cluster ===================

@dataclass(slots=True)
class Vault(Statement):
    action: str = ""          # set/get/delete/list/rotate/grant/revoke/init
    key: Optional[str] = None
    value: Optional[str] = None
    entity: Optional[str] = None
    pattern: Optional[str] = None


@dataclass(slots=True)
class Cache(Statement):
    action: str = ""          # init/stats/clear/evict/get/put/semantic_get/semantic_put
    key: Optional[str] = None
    value: Optional[str] = None
    threshold: Optional[float] = None
    embedding: Optional[List[float]] = None
    count: Optional[int] = None


@dataclass(slots=True)
class Blob(Statement):
    action: str = ""          # init/put/get/delete/info/link/unlink/links/
    #                           tag/untag/verify/gc/repair/stats/meta_set/meta_get
    name: Optional[str] = None
    data: Optional[str] = None
    path: Optional[str] = None
    content_type: Optional[str] = None
    creator: Optional[str] = None
    entity: Optional[str] = None
    tag: Optional[str] = None
    meta_key: Optional[str] = None
    meta_value: Optional[str] = None
    full: bool = False


@dataclass(slots=True)
class Blobs(Statement):
    mode: str = "all"         # all/for/by_tag/where_type/similar
    pattern: Optional[str] = None
    entity: Optional[str] = None
    tag: Optional[str] = None
    content_type: Optional[str] = None
    artifact: Optional[str] = None
    limit: Optional[int] = None


@dataclass(slots=True)
class Checkpoint(Statement):
    name: Optional[str] = None


@dataclass(slots=True)
class Checkpoints(Statement):
    limit: Optional[int] = None


@dataclass(slots=True)
class Rollback(Statement):
    target: str = ""


@dataclass(slots=True)
class Chain(Statement):
    action: str = ""          # begin/commit/rollback/height/tip/block/verify/
    #                           history/similar/drift
    height: Optional[int] = None
    key: Optional[str] = None
    embedding: Optional[List[float]] = None
    limit: Optional[int] = None
    from_height: Optional[int] = None
    to_height: Optional[int] = None


@dataclass(slots=True)
class Cluster(Statement):
    action: str = ""          # connect/disconnect/status/nodes/leader
    address: Optional[str] = None


@dataclass(slots=True)
class Explain(Statement):
    inner: Optional[Statement] = None


@dataclass(slots=True)
class Empty(Statement):
    pass
