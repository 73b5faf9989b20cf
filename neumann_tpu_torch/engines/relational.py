"""Relational engine: SQL-ish tables on columnar slabs.

Copy of ``neumann_tpu.engines.relational`` with only its import lines
changed (the store and the native codec are the port's own); host
only, no torch.

Capability parity with relational_engine (relational_engine/src/lib.rs):
schema + constraints (PRIMARY KEY, UNIQUE, NOT NULL, FOREIGN KEY with
referential actions), hash + btree indexes, WHERE scans, joins
(inner/left/right/full/cross/natural), aggregates with GROUP BY/HAVING,
ORDER BY/LIMIT/OFFSET, transactions with an overlay workspace, and
columnar materialization.

TPU-first layout: each column is a typed numpy array with a null bitmap
and a table-wide alive bitmap; WHERE compiles to one vectorized bitmap
expression (Condition.evaluate_columnar — the numpy equivalent of the
reference's hand-written SIMD filters, relational_engine/src/simd.rs:6-311).
The same bitmap feeds the vector engine's masked device scan for hybrid
queries, and big numeric filter columns can be shipped to the device once
and filtered there.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.utils.errors import RelationalError

COLUMN_TYPES = ("int", "float", "text", "bool", "vector")
_FK_ACTIONS = ("restrict", "cascade", "set_null", "set_default")


@dataclass(frozen=True)
class ForeignKey:
    table: str
    column: str
    on_delete: str = "restrict"
    on_update: str = "restrict"


@dataclass
class Column:
    name: str
    ctype: str
    nullable: bool = True
    unique: bool = False
    primary_key: bool = False
    default: object = None
    references: Optional[ForeignKey] = None
    check: Optional[Condition] = None

    def validate(self) -> None:
        if self.ctype not in COLUMN_TYPES:
            raise RelationalError(f"unknown column type {self.ctype}")
        if self.references:
            for act in (self.references.on_delete,
                        self.references.on_update):
                if act not in _FK_ACTIONS:
                    raise RelationalError(f"bad FK action {act}")


_DTYPES = {"int": np.int64, "float": np.float64, "bool": np.bool_}
_MIN_CAP = 64


class _HashIndex:
    """Equality index: value -> set of row positions."""

    def __init__(self):
        self.map: Dict[object, set] = {}

    def add(self, value, row: int) -> None:
        if value is None:
            return
        self.map.setdefault(value, set()).add(row)

    def remove(self, value, row: int) -> None:
        s = self.map.get(value)
        if s is not None:
            s.discard(row)
            if not s:
                del self.map[value]

    def lookup(self, value) -> set:
        return self.map.get(value, set())


class _BTreeIndex:
    """Range index with lazy sorted rebuild (argsort on first range query
    after a mutation) — the TPU-friendly answer to the reference's
    splitting B-trees: sorting a column is one vectorized op."""

    def __init__(self):
        self.dirty = True
        self._order: Optional[np.ndarray] = None
        self._values: Optional[np.ndarray] = None

    def invalidate(self) -> None:
        self.dirty = True

    def _rebuild(self, values: np.ndarray, valid: np.ndarray) -> None:
        rows = np.nonzero(valid)[0]
        vals = values[rows]
        order = np.argsort(vals, kind="stable")
        self._order = rows[order]
        self._values = vals[order]
        self.dirty = False

    def range(self, values, valid, lo=None, hi=None,
              lo_strict=False, hi_strict=False) -> np.ndarray:
        if self.dirty:
            self._rebuild(values, valid)
        v = self._values
        start = 0 if lo is None else int(
            np.searchsorted(v, lo, side="right" if lo_strict else "left"))
        end = len(v) if hi is None else int(
            np.searchsorted(v, hi, side="left" if hi_strict else "right"))
        return self._order[start:end]


class _Table:
    def __init__(self, name: str, columns: List[Column],
                 checks: Optional[List[Condition]] = None,
                 composite_uniques: Optional[List[Sequence[str]]] = None):
        self.name = name
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise RelationalError("duplicate column names")
        if "_id" in names:
            raise RelationalError("_id is a reserved column")
        for c in columns:
            c.validate()
        self.columns = columns
        self.by_name = {c.name: c for c in columns}
        self.cap = _MIN_CAP
        self.n = 0
        self.alive = np.zeros(self.cap, bool)
        self.data: Dict[str, np.ndarray] = {}
        self.nulls: Dict[str, np.ndarray] = {}
        for c in columns:
            self.data[c.name] = self._empty(c.ctype, self.cap)
            self.nulls[c.name] = np.ones(self.cap, bool)
        self.hash_indexes: Dict[str, _HashIndex] = {}
        self.btree_indexes: Dict[str, _BTreeIndex] = {}
        # constraint-free tables take the single-insert fast path
        # (indexes are re-checked at insert time — they can appear later)
        self.plain = (not checks and not composite_uniques
                      and all(c.nullable and not c.unique
                              and not c.primary_key
                              and c.references is None
                              and c.check is None for c in columns))
        self.lock = threading.RLock()
        pks = [c for c in columns if c.primary_key]
        self.pk: Optional[Column] = pks[0] if pks else None
        if len(pks) > 1:
            raise RelationalError("multiple primary keys")
        # PK and UNIQUE columns always get a hash index
        for c in columns:
            if c.primary_key or c.unique:
                self.hash_indexes[c.name] = _HashIndex()
        # CHECK constraints + composite UNIQUE / PRIMARY KEY groups
        self.checks: List[Condition] = list(checks or [])
        self.composite_uniques: List[Tuple[str, ...]] = []
        for group in composite_uniques or []:
            for g in group:
                if g not in self.by_name:
                    raise RelationalError(
                        f"unique constraint on unknown column {g}")
            self.composite_uniques.append(tuple(group))
            # index the first column so the uniqueness probe is selective
            self.hash_indexes.setdefault(group[0], _HashIndex())

    @staticmethod
    def _empty(ctype: str, cap: int) -> np.ndarray:
        if ctype in _DTYPES:
            return np.zeros(cap, _DTYPES[ctype])
        return np.empty(cap, object)

    def _grow(self, need: int) -> None:
        if need <= self.cap:
            return
        new_cap = self.cap
        while new_cap < need:
            new_cap *= 2
        for name, arr in self.data.items():
            grown = self._empty(self.by_name[name].ctype, new_cap)
            grown[: self.cap] = arr
            self.data[name] = grown
            nn = np.ones(new_cap, bool)
            nn[: self.cap] = self.nulls[name]
            self.nulls[name] = nn
        alive = np.zeros(new_cap, bool)
        alive[: self.cap] = self.alive
        self.alive = alive
        self.cap = new_cap

    # -- value coercion ---------------------------------------------------
    @staticmethod
    def coerce(col: Column, value):
        if value is None:
            return None
        t = col.ctype
        try:
            if t == "int":
                if isinstance(value, bool):
                    return int(value)
                if isinstance(value, float) and not value.is_integer():
                    raise RelationalError(
                        f"non-integer value for int column {col.name}")
                return int(value)
            if t == "float":
                return float(value)
            if t == "bool":
                if isinstance(value, bool):
                    return value
                raise RelationalError(
                    f"expected bool for column {col.name}")
            if t == "text":
                if not isinstance(value, str):
                    raise RelationalError(
                        f"expected text for column {col.name}")
                return value
            if t == "vector":
                return np.asarray(value, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise RelationalError(
                f"bad value for column {col.name}: {e}") from e
        raise RelationalError(f"unknown type {t}")

    def row_dict(self, row: int, cols: Optional[Sequence[str]] = None
                 ) -> Dict[str, object]:
        out = {"_id": int(row)}
        for c in self.columns:
            if cols is not None and c.name not in cols:
                continue
            if self.nulls[c.name][row]:
                out[c.name] = None
            else:
                v = self.data[c.name][row]
                if c.ctype == "int":
                    v = int(v)
                elif c.ctype == "float":
                    v = float(v)
                elif c.ctype == "bool":
                    v = bool(v)
                out[c.name] = v
        if cols is not None and "_id" not in cols and "_id" in out:
            # keep _id unless explicitly projected away
            if "_id" not in cols:
                del out["_id"]
        return out

    def live_rows(self) -> np.ndarray:
        return np.nonzero(self.alive[: self.n])[0]


class QueryDeadline:
    """Wall-clock guard for long scans (reference: Deadline/search_timeout,
    relational cursors & timeouts capability)."""

    def __init__(self, timeout_s):
        import time as _time

        self._expires = (_time.monotonic() + timeout_s
                         if timeout_s else None)

    def check(self) -> None:
        import time as _time

        if self._expires is not None and _time.monotonic() > self._expires:
            raise RelationalError("query timeout exceeded")


class _NoDeadline:
    """Shared no-op guard for the (default) no-timeout path — skips a
    per-select allocation on point lookups."""

    __slots__ = ()

    @staticmethod
    def check() -> None:
        return None


_NO_DEADLINE = _NoDeadline()


class RelationalEngine:
    """Optionally store-backed: with a TensorStore attached, schemas live
    at ``_schema:{table}`` and rows at ``table:{name}:{_id}`` (the
    reference's slab-router prefix, slab_router.rs:9-15), so WAL replay
    and snapshots rebuild tables via the put/delete hooks."""

    def __init__(self, store=None, query_timeout_s: float = 0.0):
        self.store = store
        self.query_timeout_s = query_timeout_s
        self._tables: Dict[str, _Table] = {}
        self._lock = threading.RLock()
        self._tx_counter = 0
        self._txs: Dict[int, dict] = {}
        self._self_write = threading.local()
        if store is not None:
            store.on_put(self._on_store_put)
            store.on_delete(self._on_store_delete)

    # ------------------------------------------------------------------
    # store persistence + replay hooks
    # ------------------------------------------------------------------
    def _persisting(self) -> bool:
        return getattr(self._self_write, "on", False)

    class _SelfWrite:
        def __init__(self, eng):
            self.eng = eng

        def __enter__(self):
            self.eng._self_write.on = True

        def __exit__(self, *exc):
            self.eng._self_write.on = False

    def _persist_schema(self, t: _Table) -> None:
        if self.store is None:
            return
        import json

        from neumann_tpu_torch.store.tensor_store import (
            TensorData,
            TensorValue,
        )

        spec = {
            "columns": [
                {"name": c.name, "ctype": c.ctype, "nullable": c.nullable,
                 "unique": c.unique, "primary_key": c.primary_key,
                 "default": c.default,
                 "references": ([c.references.table, c.references.column,
                                 c.references.on_delete,
                                 c.references.on_update]
                                if c.references else None),
                 "check": c.check.to_dict() if c.check else None}
                for c in t.columns],
            "hash_indexes": sorted(t.hash_indexes),
            "btree_indexes": sorted(t.btree_indexes),
            "checks": [ch.to_dict() for ch in t.checks],
            "uniques": [list(g) for g in t.composite_uniques],
        }
        td = TensorData()
        td.set("spec", TensorValue.scalar(json.dumps(spec)))
        with self._SelfWrite(self):
            self.store.put(f"_schema:{t.name}", td)

    def _persist_row(self, t: _Table, r: int) -> None:
        if self.store is None:
            return
        from neumann_tpu_torch.store.tensor_store import (
            TensorData,
            TensorValue,
        )

        td = TensorData()
        for c in t.columns:
            if t.nulls[c.name][r]:
                continue
            v = t.data[c.name][r]
            if c.ctype == "vector":
                td.set(c.name, TensorValue.vector(v))
            else:
                td.set(c.name, TensorValue.scalar(
                    _hashable(v) if not isinstance(v, (str, bytes)) else v))
        with self._SelfWrite(self):
            self.store.put(f"table:{t.name}:{r}", td)

    def _persist_delete(self, t: _Table, r: int) -> None:
        if self.store is None:
            return
        with self._SelfWrite(self):
            self.store.delete(f"table:{t.name}:{r}")

    def _on_store_put(self, key: str, data) -> None:
        if self._persisting():
            return
        if key.startswith("_schema:"):
            import json

            name = key[len("_schema:"):]
            spec = json.loads(data.get("spec").value)
            with self._lock:
                if name not in self._tables:
                    cols = []
                    for c in spec["columns"]:
                        fk = None
                        if c["references"]:
                            fk = ForeignKey(*c["references"])
                        cols.append(Column(
                            c["name"], c["ctype"], nullable=c["nullable"],
                            unique=c["unique"],
                            primary_key=c["primary_key"],
                            default=c["default"], references=fk,
                            check=(Condition.from_dict(c["check"])
                                   if c.get("check") else None)))
                    self._tables[name] = _Table(
                        name, cols,
                        checks=[Condition.from_dict(ch)
                                for ch in spec.get("checks", [])],
                        composite_uniques=spec.get("uniques"))
                t = self._tables[name]
                for col in spec.get("hash_indexes", []):
                    if col not in t.hash_indexes and col in t.by_name:
                        self.create_index(name, col)
                for col in spec.get("btree_indexes", []):
                    if col in t.by_name:
                        t.btree_indexes.setdefault(col, _BTreeIndex())
        elif key.startswith("table:"):
            rest = key[len("table:"):]
            name, sep, rid = rest.rpartition(":")
            if not sep:
                return
            with self._lock:
                t = self._tables.get(name)
            if t is None:
                return
            values = {}
            for c in t.columns:
                v = data.get(c.name)
                if v is None:
                    values[c.name] = None
                elif c.ctype == "vector":
                    values[c.name] = v.to_dense()
                else:
                    values[c.name] = v.value
            self._apply_row(t, int(rid), values)

    def _on_store_delete(self, key: str) -> None:
        if self._persisting():
            return
        if key.startswith("_schema:"):
            with self._lock:
                self._tables.pop(key[len("_schema:"):], None)
        elif key.startswith("table:"):
            rest = key[len("table:"):]
            name, sep, rid = rest.rpartition(":")
            if not sep:
                return
            with self._lock:
                t = self._tables.get(name)
            if t is None:
                return
            r = int(rid)
            with t.lock:
                if 0 <= r < t.n and t.alive[r]:
                    for c in t.columns:
                        hidx = t.hash_indexes.get(c.name)
                        if hidx is not None and not t.nulls[c.name][r]:
                            hidx.remove(_hashable(t.data[c.name][r]), r)
                        bidx = t.btree_indexes.get(c.name)
                        if bidx is not None:
                            bidx.invalidate()
                    t.alive[r] = False

    def _apply_row(self, t: _Table, r: int, values: Dict[str, object]
                   ) -> None:
        """Replay a row at an explicit position (WAL/snapshot path)."""
        with t.lock:
            t._grow(r + 1)
            if t.alive[r]:
                for c in t.columns:
                    hidx = t.hash_indexes.get(c.name)
                    if hidx is not None and not t.nulls[c.name][r]:
                        hidx.remove(_hashable(t.data[c.name][r]), r)
            for c in t.columns:
                v = values.get(c.name)
                if v is None:
                    t.nulls[c.name][r] = True
                else:
                    t.nulls[c.name][r] = False
                    t.data[c.name][r] = t.coerce(c, v)
                    hidx = t.hash_indexes.get(c.name)
                    if hidx is not None:
                        hidx.add(_hashable(t.coerce(c, v)), r)
                bidx = t.btree_indexes.get(c.name)
                if bidx is not None:
                    bidx.invalidate()
            t.alive[r] = True
            t.n = max(t.n, r + 1)

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def create_table(self, name: str, columns: List[Column],
                     checks: Optional[List[Condition]] = None,
                     uniques: Optional[List[Sequence[str]]] = None
                     ) -> None:
        """checks: table-level CHECK conditions; uniques: composite
        UNIQUE / PRIMARY KEY column groups."""
        with self._lock:
            if name in self._tables:
                raise RelationalError(f"table '{name}' already exists")
            for c in columns:
                if c.references and c.references.table != name and \
                        c.references.table not in self._tables:
                    raise RelationalError(
                        f"FK references unknown table {c.references.table}")
            t = _Table(name, columns, checks=checks,
                       composite_uniques=uniques)
            self._tables[name] = t
        self._persist_schema(t)

    def drop_table(self, name: str) -> bool:
        with self._lock:
            # restrict if other tables reference this one
            for other in self._tables.values():
                if other.name == name:
                    continue
                for c in other.columns:
                    if c.references and c.references.table == name:
                        raise RelationalError(
                            f"table '{name}' is referenced by "
                            f"{other.name}.{c.name}")
            t = self._tables.pop(name, None)
        if t is not None and self.store is not None:
            with self._SelfWrite(self):
                self.store.delete(f"_schema:{name}")
                for k in self.store.scan(f"table:{name}:"):
                    self.store.delete(k)
        return t is not None

    def list_tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def describe(self, name: str) -> List[Dict[str, object]]:
        t = self._table(name)
        out = []
        for c in t.columns:
            ref = None
            if c.references:
                ref = f"{c.references.table}.{c.references.column}"
                acts = []
                if c.references.on_delete != "restrict":
                    acts.append(f"on delete {c.references.on_delete}")
                if c.references.on_update != "restrict":
                    acts.append(f"on update {c.references.on_update}")
                if acts:
                    ref += f" ({', '.join(acts)})"
            out.append({
                "name": c.name, "type": c.ctype, "nullable": c.nullable,
                "unique": c.unique, "primary_key": c.primary_key,
                "references": ref,
                "check": (c.check.to_dict() if c.check else None)})
        return out

    def table_constraints(self, name: str) -> Dict[str, list]:
        """Table-level CHECK and composite-unique constraint specs."""
        t = self._table(name)
        return {"checks": [ch.to_dict() for ch in t.checks],
                "uniques": [list(g) for g in t.composite_uniques]}

    def table_exists(self, name: str) -> bool:
        with self._lock:
            return name in self._tables

    def row_count(self, name: str) -> int:
        t = self._table(name)
        with t.lock:
            return int(t.alive[: t.n].sum())

    def _table(self, name: str) -> _Table:
        with self._lock:
            t = self._tables.get(name)
        if t is None:
            raise RelationalError(f"unknown table '{name}'")
        return t

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------
    def _check_insert(self, t: _Table, values: Dict[str, object],
                      skip_row: Optional[int] = None) -> None:
        for c in t.columns:
            v = values.get(c.name)
            if v is None and (not c.nullable or c.primary_key):
                raise RelationalError(
                    f"column {c.name} cannot be NULL")
            if v is not None and (c.unique or c.primary_key):
                idx = t.hash_indexes[c.name]
                hits = idx.lookup(_hashable(v))
                hits = {h for h in hits if h != skip_row}
                if hits:
                    raise RelationalError(
                        f"duplicate value for unique column {c.name}")
            if v is not None and c.references:
                ref = self._table(c.references.table)
                with ref.lock:
                    if not self._fk_target_exists(ref, c.references.column, v):
                        raise RelationalError(
                            f"FK violation: {c.references.table}."
                            f"{c.references.column} = {v!r} not found")
            if c.check is not None and not self._check_passes(
                    c.check, values):
                raise RelationalError(
                    f"CHECK constraint failed on column {c.name}")
        for check in t.checks:
            if not self._check_passes(check, values):
                raise RelationalError("CHECK constraint failed")
        for group in t.composite_uniques:
            vals = tuple(values.get(g) for g in group)
            if any(v is None for v in vals):
                continue          # SQL: NULLs never conflict
            probe = t.hash_indexes[group[0]]
            for h in probe.lookup(_hashable(vals[0])):
                if h == skip_row:
                    continue
                h = int(h)
                if all(not t.nulls[g][h]
                       and _hashable(t.data[g][h]) == _hashable(vg)
                       for g, vg in zip(group, vals)):
                    raise RelationalError(
                        f"duplicate value for unique columns "
                        f"({', '.join(group)})")

    @staticmethod
    def _check_passes(check: Condition, values: Dict[str, object]) -> bool:
        # SQL CHECK semantics: only a definite FALSE rejects; a NULL
        # input makes the predicate unknown, which passes
        if any(values.get(col) is None for col in check.columns()):
            return True
        return check.evaluate_row(values)

    def _fk_target_exists(self, ref: _Table, col: str, value) -> bool:
        if col == "_id":
            r = int(value)
            return 0 <= r < ref.n and bool(ref.alive[r])
        hidx = ref.hash_indexes.get(col)
        if hidx is not None:
            return bool(hidx.lookup(_hashable(value)))
        rows = ref.live_rows()
        arr = ref.data[col]
        nn = ref.nulls[col]
        return any(not nn[r] and arr[r] == value for r in rows)

    # ------------------------------------------------------------------
    # DML
    # ------------------------------------------------------------------
    def insert(self, name: str, row: Dict[str, object]) -> int:
        t = self._table(name)
        with t.lock:
            return self._insert_locked(t, row)

    def _insert_locked(self, t: _Table, row: Dict[str, object]) -> int:
        by_name = t.by_name
        for k in row:
            if k not in by_name and k != "_id":
                raise RelationalError(
                    f"unknown column {k} in table {t.name}")
        if t.plain and not t.hash_indexes and not t.btree_indexes:
            # constraint- and index-free: skip the check loop, the
            # values dict, and the per-column index probes
            pos = t.n
            if pos >= t.cap:
                t._grow(pos + 1)
            coerce = t.coerce
            get = row.get
            for c in t.columns:
                v = get(c.name, c.default)
                if v is not None:           # fresh rows default to NULL
                    name = c.name
                    t.data[name][pos] = coerce(c, v)
                    t.nulls[name][pos] = False
            t.alive[pos] = True
            t.n = pos + 1
            if self.store is not None:
                self._persist_row(t, pos)
            return pos
        values = {}
        for c in t.columns:
            v = row.get(c.name, c.default)
            values[c.name] = t.coerce(c, v)
        self._check_insert(t, values)
        pos = t.n
        t._grow(pos + 1)
        for c in t.columns:
            v = values[c.name]
            if v is None:
                t.nulls[c.name][pos] = True
            else:
                t.nulls[c.name][pos] = False
                t.data[c.name][pos] = v
            hidx = t.hash_indexes.get(c.name)
            if hidx is not None and v is not None:
                hidx.add(_hashable(v), pos)
            bidx = t.btree_indexes.get(c.name)
            if bidx is not None:
                bidx.invalidate()
        t.alive[pos] = True
        t.n = pos + 1
        self._persist_row(t, pos)
        return pos

    def insert_many(self, name: str, rows: Sequence[Dict[str, object]]
                    ) -> List[int]:
        t = self._table(name)
        with t.lock:
            if self._can_bulk_insert(t):
                try:
                    return self._bulk_insert_locked(t, rows)
                except _BulkFallback:
                    pass
            return [self._insert_locked(t, row) for row in rows]

    @staticmethod
    def _can_bulk_insert(t: _Table) -> bool:
        """Constraint- and index-free tables take the columnar path."""
        return (not t.checks and not t.composite_uniques
                and not t.hash_indexes and not t.btree_indexes
                and all(c.nullable and not c.unique
                        and not c.primary_key and c.references is None
                        and c.check is None for c in t.columns))

    def _bulk_insert_locked(self, t: _Table,
                            rows: Sequence[Dict[str, object]]
                            ) -> List[int]:
        n = len(rows)
        if n == 0:
            return []
        allowed = set(t.by_name)
        for r in rows:
            for k in r:
                if k not in allowed and k != "_id":
                    raise RelationalError(
                        f"unknown column {k} in table {t.name}")
        base = t.n
        t._grow(base + n)
        for c in t.columns:
            raw = [r.get(c.name, c.default) for r in rows]
            if c.ctype in _DTYPES and not any(v is None for v in raw):
                arr = np.asarray(raw)
                kind = arr.dtype.kind
                ok = ((c.ctype == "int" and kind in "iub")
                      or (c.ctype == "float" and kind in "iufb")
                      or (c.ctype == "bool" and kind == "b"))
                if not ok:
                    raise _BulkFallback()     # odd types: exact path
                if c.ctype == "int" and kind == "f":
                    raise _BulkFallback()
                t.data[c.name][base:base + n] = arr.astype(
                    _DTYPES[c.ctype])
                t.nulls[c.name][base:base + n] = False
            else:
                # per-value coercion (text/vector columns or NULLs)
                col_arr = t.data[c.name]
                null_arr = t.nulls[c.name]
                for i, v in enumerate(raw):
                    cv = t.coerce(c, v)
                    if cv is None:
                        null_arr[base + i] = True
                    else:
                        null_arr[base + i] = False
                        col_arr[base + i] = cv
        t.alive[base:base + n] = True
        t.n = base + n
        if self.store is not None:
            for r in range(base, base + n):
                self._persist_row(t, r)
        return list(range(base, base + n))

    # -- selection -------------------------------------------------------
    def _match_rows(self, t: _Table, condition: Optional[Condition]
                    ) -> np.ndarray:
        """Row positions matching condition, using indexes when simple."""
        if condition is None or condition.op == "true":
            return t.live_rows()
        # index fast paths
        if condition.op == "=" and condition.column in t.hash_indexes:
            rows = t.hash_indexes[condition.column].lookup(
                _hashable(condition.value))
            return np.array(sorted(r for r in rows if t.alive[r]),
                            dtype=np.int64)
        if condition.op == "=" and condition.column == "_id":
            r = int(condition.value)
            if 0 <= r < t.n and t.alive[r]:
                return np.array([r], dtype=np.int64)
            return np.array([], dtype=np.int64)
        if condition.op in ("<", "<=", ">", ">=") and \
                condition.column in t.btree_indexes:
            valid = t.alive[: t.n] & ~t.nulls[condition.column][: t.n]
            b = t.btree_indexes[condition.column]
            vals = t.data[condition.column][: t.n]
            if condition.op == "<":
                rows = b.range(vals, valid, hi=condition.value,
                               hi_strict=True)
            elif condition.op == "<=":
                rows = b.range(vals, valid, hi=condition.value)
            elif condition.op == ">":
                rows = b.range(vals, valid, lo=condition.value,
                               lo_strict=True)
            else:
                rows = b.range(vals, valid, lo=condition.value)
            return np.sort(rows)
        # vectorized bitmap scan
        n = t.n
        cols = {name: arr[:n] for name, arr in t.data.items()}
        nulls = {name: arr[:n] for name, arr in t.nulls.items()}
        sel = condition.evaluate_columnar(cols, nulls, n)
        sel &= t.alive[:n]
        return np.nonzero(sel)[0]

    def selection_bitmap(self, name: str, condition: Optional[Condition]
                         ) -> np.ndarray:
        """Full-capacity bool mask of matching rows (for fused device ops)."""
        t = self._table(name)
        with t.lock:
            mask = np.zeros(t.cap, bool)
            mask[self._match_rows(t, condition)] = True
            return mask

    def select(self, name: str, condition: Optional[Condition] = None,
               columns: Optional[Sequence[str]] = None,
               order_by: Optional[Sequence[Tuple[str, bool]]] = None,
               limit: Optional[int] = None, offset: int = 0,
               timeout_s: Optional[float] = None
               ) -> List[Dict[str, object]]:
        if (condition is not None and order_by is None and offset == 0
                and timeout_s is None and not self.query_timeout_s
                and condition.op == "="):
            # point-lookup fast path: indexed equality skips the
            # deadline plumbing and the numpy row-set round trip
            t = self._table(name)
            with t.lock:
                col = condition.column
                if col == "_id":
                    r = int(condition.value)
                    hits = [r] if 0 <= r < t.n and t.alive[r] else []
                else:
                    idx = t.hash_indexes.get(col)
                    if idx is None:
                        hits = None
                    else:
                        alive = t.alive
                        hits = sorted(
                            int(r)
                            for r in idx.lookup(_hashable(condition.value))
                            if alive[r])
                if hits is not None:
                    if limit is not None:
                        hits = hits[:limit]
                    return [t.row_dict(r, columns) for r in hits]
        eff_timeout = (timeout_s if timeout_s is not None
                       else self.query_timeout_s)
        deadline = QueryDeadline(eff_timeout) if eff_timeout \
            else _NO_DEADLINE
        t = self._table(name)
        with t.lock:
            rows = self._match_rows(t, condition)
            deadline.check()
            if len(rows) <= 32:
                # tiny results (indexed lookups): per-row path beats
                # the columnar gather's fixed overhead
                out = [t.row_dict(int(r), None) for r in rows]
            else:
                # columnar materialization: gather each column once
                # and build rows straight from the numpy buffers
                # (native rows_from_arrays; ~4x the per-row row_dict
                # path — same builder as the join)
                rows = np.asarray(rows, np.int64)
                from neumann_tpu_torch.native import pycodec

                ext = pycodec.load()
                if ext is not None and hasattr(ext, "rows_from_arrays"):
                    names = ["_id"] + [c.name for c in t.columns]
                    arrays: List[np.ndarray] = [rows]
                    nmasks: List[Optional[np.ndarray]] = [None]
                    for c in t.columns:
                        arrays.append(t.data[c.name][rows])
                        nulls = t.nulls[c.name][rows]
                        nmasks.append(nulls if nulls.any() else None)
                    deadline.check()
                    out = ext.rows_from_arrays(tuple(names), arrays,
                                               nmasks)
                else:
                    names = ["_id"] + [c.name for c in t.columns]
                    cols: List[list] = [rows.tolist()]
                    for c in t.columns:
                        vals = t.data[c.name][rows]
                        nulls = t.nulls[c.name][rows]
                        pv = (vals.tolist()
                              if c.ctype in ("int", "float", "bool")
                              else list(vals))
                        if nulls.any():
                            pv = [None if d else v
                                  for v, d in zip(pv, nulls)]
                        cols.append(pv)
                    deadline.check()
                    out = _row_builder(tuple(names))(cols)
        if order_by:
            # specs: (col, desc) or (col, desc, nulls_first); default
            # placement is SQL's NULLS LAST asc / NULLS FIRST desc
            for spec in reversed(list(order_by)):
                col, desc = spec[0], spec[1]
                nf = spec[2] if len(spec) > 2 else desc
                out.sort(
                    key=lambda r: ((r.get(col) is None) ^ nf ^ desc,
                                   _sort_key(r.get(col))),
                    reverse=desc)
        if offset:
            out = out[offset:]
        if limit is not None:
            out = out[:limit]
        if columns is not None:
            keep = list(columns)
            out = [{k: r.get(k) for k in keep} for r in out]
        return out

    def select_columnar(self, name: str,
                        condition: Optional[Condition] = None,
                        columns: Optional[Sequence[str]] = None
                        ) -> Dict[str, np.ndarray]:
        """Columnar materialization of matching rows."""
        t = self._table(name)
        with t.lock:
            rows = self._match_rows(t, condition)
            names = [c.name for c in t.columns
                     if columns is None or c.name in columns]
            out: Dict[str, np.ndarray] = {"_id": rows.copy()}
            for cn in names:
                arr = t.data[cn][rows]
                nn = t.nulls[cn][rows]
                if t.by_name[cn].ctype in _DTYPES:
                    out[cn] = np.where(nn, np.nan, arr.astype(np.float64)) \
                        if t.by_name[cn].ctype == "float" else arr.copy()
                else:
                    a = arr.copy()
                    a[nn] = None
                    out[cn] = a
            return out

    def get_row(self, name: str, row_id: int) -> Optional[Dict[str, object]]:
        t = self._table(name)
        with t.lock:
            if 0 <= row_id < t.n and t.alive[row_id]:
                return t.row_dict(row_id)
            return None

    # -- update / delete --------------------------------------------------
    def update(self, name: str, condition: Optional[Condition],
               updates: Dict[str, object]) -> int:
        t = self._table(name)
        with t.lock:
            for k in updates:
                if k not in t.by_name:
                    raise RelationalError(f"unknown column {k}")
            rows = self._match_rows(t, condition)
            for r in rows:
                r = int(r)
                current = {c.name: (None if t.nulls[c.name][r]
                                    else t.data[c.name][r])
                           for c in t.columns}
                newvals = dict(current)
                for k, v in updates.items():
                    if hasattr(v, "evaluate"):   # SET col = <expression>
                        v = v.evaluate(current)
                    newvals[k] = t.coerce(t.by_name[k], v)
                self._check_insert(t, newvals, skip_row=r)
                changed = {
                    k: (current[k], newvals[k]) for k in updates
                    if _hashable(current[k]) != _hashable(newvals[k])}
                if changed:
                    self._apply_on_update_actions(t, r, changed)
                for k, v in updates.items():
                    c = t.by_name[k]
                    old = None if t.nulls[k][r] else t.data[k][r]
                    hidx = t.hash_indexes.get(k)
                    if hidx is not None and old is not None:
                        hidx.remove(_hashable(old), r)
                    nv = newvals[k]
                    if nv is None:
                        t.nulls[k][r] = True
                    else:
                        t.nulls[k][r] = False
                        t.data[k][r] = nv
                        if hidx is not None:
                            hidx.add(_hashable(nv), r)
                    bidx = t.btree_indexes.get(k)
                    if bidx is not None:
                        bidx.invalidate()
                self._persist_row(t, r)
            return len(rows)

    def delete(self, name: str, condition: Optional[Condition]) -> int:
        t = self._table(name)
        with t.lock:
            rows = [int(r) for r in self._match_rows(t, condition)]
            for r in rows:
                self._delete_row(t, r)
            return len(rows)

    def _delete_row(self, t: _Table, r: int) -> None:
        # referential actions on tables referencing t
        with self._lock:
            referrers = [
                (other, c) for other in self._tables.values()
                for c in other.columns
                if c.references and c.references.table == t.name]
        for other, c in referrers:
            refcol = c.references.column
            if refcol == "_id":
                target = r
            else:
                target = None if t.nulls[refcol][r] else t.data[refcol][r]
                if target is None:
                    continue
            cond = Condition.eq(c.name, target)
            hits = self._match_rows(other, cond) if other is not t else \
                self._match_rows(other, cond)
            if len(hits) == 0:
                continue
            action = c.references.on_delete
            if action == "restrict":
                raise RelationalError(
                    f"delete restricted: {other.name}.{c.name} references "
                    f"{t.name} row {r}")
            if action == "cascade":
                for h in hits:
                    self._delete_row(other, int(h))
            elif action in ("set_null", "set_default"):
                repl = (other.coerce(c, c.default)
                        if action == "set_default" else None)
                for h in hits:
                    h = int(h)
                    self._set_fk_value(other, c, h, repl)
        for c in t.columns:
            hidx = t.hash_indexes.get(c.name)
            if hidx is not None and not t.nulls[c.name][r]:
                hidx.remove(_hashable(t.data[c.name][r]), r)
            bidx = t.btree_indexes.get(c.name)
            if bidx is not None:
                bidx.invalidate()
        t.alive[r] = False
        self._persist_delete(t, r)

    def _set_fk_value(self, t: _Table, c: Column, r: int, value) -> None:
        """Referential-action write (SET NULL / SET DEFAULT / CASCADE
        on update): keep indexes consistent and persist the row."""
        hidx = t.hash_indexes.get(c.name)
        if hidx is not None and not t.nulls[c.name][r]:
            hidx.remove(_hashable(t.data[c.name][r]), r)
        if value is None:
            t.nulls[c.name][r] = True
        else:
            t.nulls[c.name][r] = False
            t.data[c.name][r] = value
            if hidx is not None:
                hidx.add(_hashable(value), r)
        bidx = t.btree_indexes.get(c.name)
        if bidx is not None:
            bidx.invalidate()
        self._persist_row(t, r)

    def _apply_on_update_actions(self, t: _Table, r: int,
                                 changed: Dict[str, tuple]) -> None:
        """Referential ON UPDATE actions when a referenced column of
        row r changes. changed: {col: (old, new)}."""
        with self._lock:
            referrers = [
                (other, c) for other in self._tables.values()
                for c in other.columns
                if c.references and c.references.table == t.name
                and c.references.column in changed]
        for other, c in referrers:
            old, new = changed[c.references.column]
            if old is None:
                continue
            hits = [int(h) for h in self._match_rows(
                other, Condition.eq(c.name, _hashable(old)))]
            if not hits:
                continue
            action = c.references.on_update
            if action == "restrict":
                raise RelationalError(
                    f"update restricted: {other.name}.{c.name} "
                    f"references {t.name}.{c.references.column}")
            for h in hits:
                if action == "cascade":
                    self._set_fk_value(other, c, h, new)
                elif action == "set_null":
                    self._set_fk_value(other, c, h, None)
                else:  # set_default
                    self._set_fk_value(other, c, h,
                                       other.coerce(c, c.default))

    # ------------------------------------------------------------------
    # indexes
    # ------------------------------------------------------------------
    def create_index(self, table: str, column: str) -> None:
        t = self._table(table)
        with t.lock:
            if column not in t.by_name:
                raise RelationalError(f"unknown column {column}")
            if column in t.hash_indexes:
                return
            idx = _HashIndex()
            for r in t.live_rows():
                if not t.nulls[column][r]:
                    idx.add(_hashable(t.data[column][r]), int(r))
            t.hash_indexes[column] = idx
        self._persist_schema(t)

    def create_btree_index(self, table: str, column: str) -> None:
        t = self._table(table)
        with t.lock:
            if column not in t.by_name:
                raise RelationalError(f"unknown column {column}")
            if t.by_name[column].ctype not in ("int", "float", "text"):
                raise RelationalError(
                    f"btree index unsupported for {t.by_name[column].ctype}")
            t.btree_indexes.setdefault(column, _BTreeIndex())
        self._persist_schema(t)

    def drop_index(self, table: str, column: str) -> bool:
        t = self._table(table)
        with t.lock:
            a = t.hash_indexes.pop(column, None)
            b = t.btree_indexes.pop(column, None)
            col = t.by_name.get(column)
            if col is not None and (col.unique or col.primary_key) and a:
                t.hash_indexes[column] = a  # constraint indexes stay
                return b is not None
            return a is not None or b is not None

    def list_indexes(self, table: str) -> Dict[str, List[str]]:
        t = self._table(table)
        with t.lock:
            return {"hash": sorted(t.hash_indexes),
                    "btree": sorted(t.btree_indexes)}

    # ------------------------------------------------------------------
    # aggregates
    # ------------------------------------------------------------------
    def _agg_values(self, name: str, column: str,
                    condition: Optional[Condition]) -> np.ndarray:
        t = self._table(name)
        with t.lock:
            if column not in t.by_name:
                raise RelationalError(f"unknown column {column}")
            if t.by_name[column].ctype not in ("int", "float"):
                raise RelationalError(
                    f"aggregate on non-numeric column {column}")
            rows = self._match_rows(t, condition)
            nn = t.nulls[column][rows]
            # keep the column dtype: int64 SUM/MIN/MAX must not round
            # through float64 (precision loss above 2^53 — sqlite
            # keeps integer aggregates integral)
            return t.data[column][rows][~nn]

    def select_with_options(self, name: str,
                            condition: Optional[Condition] = None,
                            **options) -> List[Dict[str, object]]:
        """Name parity with select_with_options
        (relational_engine/src/lib.rs:3045); our select already takes
        the options (columns/order_by/limit/offset/timeout_s)."""
        return self.select(name, condition, **options)

    def select_streaming(self, name: str,
                         condition: Optional[Condition] = None,
                         batch_size: int = 1000,
                         max_rows: Optional[int] = None
                         ) -> "StreamingCursor":
        """Batch-fetching iterator over matching rows — large result
        sets never materialize at once (relational_engine/src/cursor.rs
        StreamingCursor)."""
        self._table(name)  # validate the table exists up front
        return StreamingCursor(self, name, condition,
                               batch_size=batch_size, max_rows=max_rows)

    def count(self, name: str, condition: Optional[Condition] = None) -> int:
        t = self._table(name)
        with t.lock:
            return int(len(self._match_rows(t, condition)))

    def count_column(self, name: str, column: str,
                     condition: Optional[Condition] = None) -> int:
        """COUNT(column): non-null values among matching rows
        (relational_engine/src/lib.rs:4480-4694 count_column)."""
        t = self._table(name)
        with t.lock:
            if column not in t.by_name:
                raise RelationalError(
                    f"no column {column} in {name}")
            rows = self._match_rows(t, condition)
            return int((~t.nulls[column][rows]).sum())

    @staticmethod
    def _agg_py(v, x):
        """Box an aggregate result with the column's type (int stays
        int; Python ints are arbitrary-precision so int64 SUM cannot
        overflow)."""
        return int(x) if v.dtype.kind in "iu" else float(x)

    def sum_column(self, name, column, condition=None):
        v = self._agg_values(name, column, condition)
        if not len(v):
            return None                             # SUM of none: NULL
        if v.dtype.kind in "iu":
            # overflow-proof WITHOUT the 1M-element Python loop that
            # made SUM@1M cost 99 ms: when n * max|v| provably fits
            # int64, one vectorized sum is exact; only pathological
            # magnitudes pay the bigint loop
            bound = max(abs(int(v.min())), abs(int(v.max())), 1)
            if len(v) <= (1 << 62) // bound:
                return int(v.sum(dtype=np.int64))
            return sum(int(x) for x in v)
        return float(v.sum())

    def avg_column(self, name, column, condition=None) -> Optional[float]:
        v = self._agg_values(name, column, condition)
        return float(v.mean()) if len(v) else None

    def min_column(self, name, column, condition=None):
        v = self._agg_values(name, column, condition)
        return self._agg_py(v, v.min()) if len(v) else None

    def max_column(self, name, column, condition=None):
        v = self._agg_values(name, column, condition)
        return self._agg_py(v, v.max()) if len(v) else None

    def distinct_values(self, name, column, condition=None) -> list:
        """Unique non-null values of a column (the DISTINCT-aggregate
        feed: COUNT/SUM/AVG/MIN/MAX over the de-duplicated set)."""
        t = self._table(name)
        with t.lock:
            if column not in t.data:
                raise RelationalError(f"no column {column}")
            rows = self._match_rows(t, condition)
            rows = rows[~t.nulls[column][rows]]
            vals = t.data[column][rows]
        return list(np.unique(vals))

    def group_by(self, name: str, group_cols: Sequence[str],
                 aggs: Sequence[Tuple[str, str, str]],
                 condition: Optional[Condition] = None,
                 having: Optional[Condition] = None
                 ) -> List[Dict[str, object]]:
        """aggs: list of (func, column, alias); func in
        count/sum/avg/min/max ('' column allowed for count)."""
        t = self._table(name)
        with t.lock:
            rows = self._match_rows(t, condition)
            groups: Dict[tuple, List[int]] = {}
            for r in rows:
                r = int(r)
                key = tuple(
                    None if t.nulls[g][r] else _hashable(t.data[g][r])
                    for g in group_cols)
                groups.setdefault(key, []).append(r)
            out = []
            for key, members in groups.items():
                rec: Dict[str, object] = {
                    g: k for g, k in zip(group_cols, key)}
                for func, col, alias in aggs:
                    # "<fn>-distinct": aggregate over unique non-null
                    # values (COUNT(DISTINCT col) and friends)
                    distinct = func.endswith("-distinct")
                    if distinct:
                        func = func[: -len("-distinct")]
                    if func == "count":
                        # COUNT(*) counts rows; COUNT(col) non-nulls
                        if not col:
                            rec[alias] = len(members)
                        elif distinct:
                            rec[alias] = len({
                                _hashable(t.data[col][m])
                                for m in members if not t.nulls[col][m]})
                        else:
                            rec[alias] = sum(
                                1 for m in members
                                if not t.nulls[col][m])
                        continue
                    if t.by_name[col].ctype not in ("int", "float"):
                        # same policy as the non-grouped path
                        # (_agg_values): clean error, not a cast blowup
                        raise RelationalError(
                            f"aggregate on non-numeric column {col}")
                    is_int = t.by_name[col].ctype == "int"
                    box = int if is_int else float
                    vals = [box(t.data[col][m]) for m in members
                            if not t.nulls[col][m]]
                    if distinct:
                        vals = list(set(vals))
                    if not vals:
                        rec[alias] = None
                    elif func == "sum":
                        rec[alias] = sum(vals)
                    elif func == "avg":
                        rec[alias] = float(sum(vals)) / len(vals)
                    elif func == "min":
                        rec[alias] = min(vals)
                    elif func == "max":
                        rec[alias] = max(vals)
                    else:
                        raise RelationalError(f"unknown aggregate {func}")
                out.append(rec)
        if having is not None:
            out = [r for r in out if having.evaluate_row(r)]
        out.sort(key=lambda r: tuple(_sort_key(r[g]) for g in group_cols))
        return out

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def join(self, left: str, right: str, left_col: str, right_col: str,
             how: str = "inner") -> List[Dict[str, object]]:
        lt, rt = self._table(left), self._table(right)
        if how not in ("inner", "left", "right", "full", "cross"):
            raise RelationalError(f"unknown join type {how}")
        if left == right:
            # self-join: the merged-row keys would collide (the
            # reference sidesteps this by returning row PAIRS,
            # lib.rs join_with_options); ":2" cannot be part of a
            # table identifier, so the alias is collision-free
            right = f"{right}:2"
        with lt.lock, rt.lock:
            lrows = [int(r) for r in lt.live_rows()]
            rrows = [int(r) for r in rt.live_rows()]
            out: List[Dict[str, object]] = []

            def merged(lr: Optional[int], rr: Optional[int]):
                rec = {}
                ld = lt.row_dict(lr) if lr is not None else {
                    c.name: None for c in lt.columns}
                rd = rt.row_dict(rr) if rr is not None else {
                    c.name: None for c in rt.columns}
                for k, v in ld.items():
                    rec[f"{left}.{k}"] = v
                for k, v in rd.items():
                    rec[f"{right}.{k}"] = v
                return rec

            if how == "cross":
                for lr in lrows:
                    for rr in rrows:
                        out.append(merged(lr, rr))
                return out

            fast = self._join_fast(lt, rt, left, right, left_col,
                                   right_col, how,
                                   np.asarray(lrows), np.asarray(rrows))
            if fast is not None:
                return fast

            def key_of(t: _Table, col: str, r: int):
                if col == "_id":
                    return r
                if t.nulls[col][r]:
                    return None
                return _hashable(t.data[col][r])

            rmap: Dict[object, List[int]] = {}
            for rr in rrows:
                k = key_of(rt, right_col, rr)
                if k is not None:
                    rmap.setdefault(k, []).append(rr)
            matched_r: set = set()
            for lr in lrows:
                k = key_of(lt, left_col, lr)
                matches = rmap.get(k, []) if k is not None else []
                if matches:
                    for rr in matches:
                        matched_r.add(rr)
                        out.append(merged(lr, rr))
                elif how in ("left", "full"):
                    out.append(merged(lr, None))
            if how in ("right", "full"):
                for rr in rrows:
                    if rr not in matched_r:
                        out.append(merged(None, rr))
            return out

    @staticmethod
    def _join_keys(t: _Table, col: str, rows: np.ndarray):
        """(keys, valid) for a typed join column, or None -> dict path."""
        if col == "_id":
            return rows.astype(np.int64), np.ones(len(rows), bool)
        c = t.by_name.get(col)
        if c is None or c.ctype not in ("int", "float", "bool"):
            return None
        keys = t.data[col][rows]
        valid = ~t.nulls[col][rows]
        if c.ctype == "float":
            valid &= ~np.isnan(keys)   # NaN keys never match (SQL null
        return keys, valid             # semantics, like the dict path)

    def _join_fast(self, lt: _Table, rt: _Table, left: str, right: str,
                   left_col: str, right_col: str, how: str,
                   lrows: np.ndarray, rrows: np.ndarray):
        """Vectorized sort-merge pair generation + columnar
        materialization for numeric keys. Returns None when a key
        column is text/vector (object dtype) — the dict path handles
        those. Output row order matches the dict path exactly."""
        lk = self._join_keys(lt, left_col, lrows)
        rk = self._join_keys(rt, right_col, rrows)
        if lk is None or rk is None:
            return None
        lkeys, lvalid = lk
        rkeys, rvalid = rk
        rrows_v = rrows[rvalid]
        rkeys_v = rkeys[rvalid]
        order = np.argsort(rkeys_v, kind="stable")
        rk_sorted = rkeys_v[order]
        lo = np.searchsorted(rk_sorted, lkeys, side="left")
        hi = np.searchsorted(rk_sorted, lkeys, side="right")
        counts = np.where(lvalid, hi - lo, 0)
        pad_unmatched = how in ("left", "full")
        eff = np.maximum(counts, 1) if pad_unmatched else counts
        total = int(eff.sum())
        l_pos = np.repeat(np.arange(len(lrows)), eff)
        starts = np.repeat(lo, eff)
        cum = np.cumsum(eff) - eff
        offs = np.arange(total) - np.repeat(cum, eff)
        matched = np.repeat(counts > 0, eff)
        r_pos = np.where(matched,
                         np.minimum(starts + offs,
                                    max(len(order) - 1, 0)), 0)
        out_l = lrows[l_pos]
        out_r = (np.where(matched, rrows_v[order[r_pos]], -1)
                 if len(order) else np.full(total, -1, np.int64))
        l_has = np.ones(total, bool)
        tail_r = None
        if how in ("right", "full"):
            hit = np.zeros(len(rrows_v), bool)
            if len(order):
                hit[order[r_pos[matched]]] = True
            tail = np.concatenate([rrows_v[~hit], rrows[~rvalid]])
            tail.sort()
            tail_r = tail
        recs = self._materialize_join(lt, rt, left, right, out_l, out_r,
                                      l_has, matched)
        if tail_r is not None and len(tail_r):
            recs.extend(self._materialize_join(
                lt, rt, left, right,
                np.full(len(tail_r), -1, np.int64), tail_r,
                np.zeros(len(tail_r), bool),
                np.ones(len(tail_r), bool)))
        return recs

    @staticmethod
    def _side_columns(t: _Table, prefix: str, rows: np.ndarray,
                      has: np.ndarray):
        """Per-column Python value lists for the output rows; rows
        where has=False yield None (and no _id key, matching
        row_dict-vs-null-side behavior of the dict path)."""
        safe = np.where(has, rows, 0)
        ids = rows.tolist()
        cols = [(f"{prefix}._id", ids)]
        all_present = bool(has.all())
        for c in t.columns:
            vals = t.data[c.name][safe]
            nulls = t.nulls[c.name][safe]
            if c.ctype in ("int", "float", "bool"):
                pv = vals.tolist()          # C-speed Python conversion
            else:
                pv = list(vals)
            if nulls.any() or not all_present:
                dead = nulls if all_present else (nulls | ~has)
                pv = [None if d else v for v, d in zip(pv, dead)]
            cols.append((f"{prefix}.{c.name}", pv))
        return cols

    @staticmethod
    def _side_arrays(t: _Table, prefix: str, rows: np.ndarray):
        """(names, arrays, nullmasks) straight from the column buffers
        — the zero-copy feed for the native row materializer."""
        names = [f"{prefix}._id"]
        arrays = [rows.astype(np.int64, copy=False)]
        masks: List[Optional[np.ndarray]] = [None]
        for c in t.columns:
            names.append(f"{prefix}.{c.name}")
            arrays.append(t.data[c.name][rows])
            nulls = t.nulls[c.name][rows]
            masks.append(nulls if nulls.any() else None)
        return names, arrays, masks

    def _materialize_join(self, lt, rt, left, right, out_l, out_r,
                          l_has, r_has):
        all_l = bool(l_has.all())
        all_r = bool(r_has.all())
        if all_l and all_r:
            from neumann_tpu_torch.native import pycodec

            ext = pycodec.load()
            if ext is not None and hasattr(ext, "rows_from_arrays"):
                # box values straight out of the numpy buffers: no
                # .tolist() intermediates, no per-row zip
                ln, la, lm = self._side_arrays(lt, left, out_l)
                rn, ra, rm = self._side_arrays(rt, right, out_r)
                return ext.rows_from_arrays(
                    tuple(ln + rn), la + ra, lm + rm)
        lcols = self._side_columns(lt, left, out_l, l_has)
        rcols = self._side_columns(rt, right, out_r, r_has)
        names = [n for n, _ in lcols] + [n for n, _ in rcols]
        l_id_name, r_id_name = lcols[0][0], rcols[0][0]
        columns = [v for _, v in lcols] + [v for _, v in rcols]
        if all_l and all_r:
            # codegen'd dict-literal builder (the namedtuple technique):
            # BUILD_MAP bytecode is ~3x dict(zip(names, tup)) per row,
            # and this loop is the join's hot spot at 100K+ output rows
            return _row_builder(tuple(names))(columns)
        recs = []
        for i, tup in enumerate(zip(*columns)):
            rec = dict(zip(names, tup))
            if not l_has[i]:
                del rec[l_id_name]          # null side carries no _id
            if not r_has[i]:
                del rec[r_id_name]
            recs.append(rec)
        return recs

    def natural_join(self, left: str, right: str) -> List[Dict[str, object]]:
        lt, rt = self._table(left), self._table(right)
        common = [c.name for c in lt.columns if c.name in rt.by_name]
        if not common:
            return self.join(left, right, "_id", "_id", "cross")
        col = common[0]
        return self.join(left, right, col, col, "inner")

    # ------------------------------------------------------------------
    # transactions (overlay workspace, applied atomically at commit)
    # ------------------------------------------------------------------
    def begin_transaction(self) -> int:
        with self._lock:
            self._tx_counter += 1
            tx = self._tx_counter
            self._txs[tx] = {"ops": []}
            return tx

    def _tx(self, tx_id: int) -> dict:
        tx = self._txs.get(tx_id)
        if tx is None:
            raise RelationalError(f"unknown transaction {tx_id}")
        return tx

    def tx_insert(self, tx_id: int, table: str, row: Dict[str, object]
                  ) -> None:
        self._tx(tx_id)["ops"].append(("insert", table, row, None))

    def tx_update(self, tx_id: int, table: str,
                  condition: Optional[Condition],
                  updates: Dict[str, object]) -> None:
        self._tx(tx_id)["ops"].append(("update", table, condition, updates))

    def tx_delete(self, tx_id: int, table: str,
                  condition: Optional[Condition]) -> None:
        self._tx(tx_id)["ops"].append(("delete", table, condition, None))

    def tx_select(self, tx_id: int, table: str,
                  condition: Optional[Condition] = None
                  ) -> List[Dict[str, object]]:
        """Read-your-writes: base rows with the overlay applied."""
        tx = self._tx(tx_id)
        rows = self.select(table, condition)
        virtual = -1
        for op, tbl, a, b in tx["ops"]:
            if tbl != table:
                continue
            if op == "insert":
                r = dict(a)
                r.setdefault("_id", virtual)
                virtual -= 1
                if condition is None or condition.evaluate_row(r):
                    rows.append(r)
            elif op == "update":
                for r in rows:
                    if a is None or a.evaluate_row(r):
                        r.update(b)
            elif op == "delete":
                rows = [r for r in rows
                        if not (a is None or a.evaluate_row(r))]
        return rows

    def commit(self, tx_id: int) -> None:
        tx = self._tx(tx_id)
        applied: List[Tuple[str, object]] = []
        try:
            with self._lock:
                for op, table, a, b in tx["ops"]:
                    if op == "insert":
                        rid = self.insert(table, a)
                        applied.append(("insert", (table, rid)))
                    elif op == "update":
                        before = self.select(table, a)
                        self.update(table, a, b)
                        applied.append(("update", (table, before, b)))
                    elif op == "delete":
                        before = self.select(table, a)
                        self.delete(table, a)
                        applied.append(("delete", (table, before)))
        except Exception:
            # undo in reverse order
            for op, info in reversed(applied):
                if op == "insert":
                    table, rid = info
                    t = self._table(table)
                    with t.lock:
                        if t.alive[rid]:
                            self._delete_row(t, rid)
                elif op == "update":
                    table, before, updates = info
                    for r in before:
                        restore = {k: r[k] for k in updates if k in r}
                        self.update(table,
                                    Condition.eq("_id", r["_id"]), restore)
                elif op == "delete":
                    table, before = info
                    for r in before:
                        self.insert(table,
                                    {k: v for k, v in r.items()
                                     if k != "_id"})
            del self._txs[tx_id]
            raise
        del self._txs[tx_id]

    def rollback(self, tx_id: int) -> None:
        self._tx(tx_id)
        del self._txs[tx_id]


class StreamingCursor:
    """Iterator that re-queries in offset batches instead of loading the
    whole result set (reference relational_engine/src/cursor.rs). Also
    iterable batch-wise via ``batches()``. Like the reference, each
    batch re-evaluates the condition at fetch time, so rows inserted or
    deleted mid-iteration may shift later batches."""

    def __init__(self, engine: "RelationalEngine", table: str,
                 condition: Optional[Condition] = None,
                 batch_size: int = 1000,
                 max_rows: Optional[int] = None):
        self.engine = engine
        self.table = table
        self.condition = condition
        self.batch_size = batch_size if batch_size > 0 else 1000
        self.max_rows = max_rows
        self.current_offset = 0
        self.rows_yielded = 0
        self._batch: List[Dict[str, object]] = []
        self._batch_index = 0
        self._exhausted = False

    def _fetch(self) -> None:
        want = self.batch_size
        if self.max_rows is not None:
            want = min(want, self.max_rows - self.rows_yielded)
        if want <= 0:
            self._exhausted = True
            return
        self._batch = self.engine.select(
            self.table, self.condition, limit=want,
            offset=self.current_offset)
        self._batch_index = 0
        self.current_offset += len(self._batch)
        if not self._batch:
            self._exhausted = True

    def __iter__(self) -> "StreamingCursor":
        return self

    def __next__(self) -> Dict[str, object]:
        if self.max_rows is not None and self.rows_yielded >= self.max_rows:
            raise StopIteration
        if self._batch_index >= len(self._batch):
            if self._exhausted:
                raise StopIteration
            self._fetch()
            if self._batch_index >= len(self._batch):
                raise StopIteration
        row = self._batch[self._batch_index]
        self._batch_index += 1
        self.rows_yielded += 1
        return row

    def batches(self):
        """Yield whole batches (reference next_batch loop)."""
        while True:
            batch = []
            for _ in range(self.batch_size):
                try:
                    batch.append(next(self))
                except StopIteration:
                    break
            if not batch:
                return
            yield batch


class _BulkFallback(Exception):
    """Internal: bulk insert hit a value mix the columnar path can't
    coerce faithfully; retry row-by-row."""


def _hashable(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


@functools.lru_cache(maxsize=256)
def _row_builder(names: tuple):
    """`columns -> [ {name: value, ...}, ... ]` for a fixed key tuple.

    Native path: the C extension builds the row dicts directly (~2x
    the codegen'd builder). Fallback: a generated dict-literal
    comprehension (BUILD_MAP bytecode), ~3x dict(zip(names, tup)) per
    row — the namedtuple technique. Keys are repr-escaped; values come
    positionally from the column lists."""
    from neumann_tpu_torch.native import pycodec

    ext = pycodec.load()
    if ext is not None:
        rows = ext.rows_from_columns
        return lambda cols, _n=tuple(names): rows(_n, cols)
    vars_ = [f"v{i}" for i in range(len(names))]
    body = ", ".join(f"{n!r}: {v}" for n, v in zip(names, vars_))
    src = (f"lambda cols: [{{{body}}} "
           f"for ({', '.join(vars_)},) in zip(*cols)]")
    return eval(src)  # noqa: S307 — inputs are column names we created


def _sort_key(v):
    # None sorts first; mixed types sort by type name then value
    if v is None:
        return (0, "", 0)
    if isinstance(v, bool):
        return (1, "bool", int(v))
    if isinstance(v, (int, float)):
        return (1, "num", float(v))
    return (2, type(v).__name__, v)
