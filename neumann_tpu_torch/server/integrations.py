"""numpy / pandas interop helpers for the SDK.

Parity with neumann-py/src/neumann/integrations/{numpy,pandas}.py:
vector <-> statement conversion, embedding parsing, similarity math,
and DataFrame bridges. pandas is optional — the bridge functions raise
a clear error when it is absent.

The port's copy of ``neumann_tpu/server/integrations.py``: only its import
lines differ.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from neumann_tpu_torch.utils.errors import NeumannError


def _fmt_vec(v) -> str:
    arr = np.asarray(v, dtype=np.float32).ravel()
    return "[" + ", ".join(repr(round(float(x), 8)) for x in arr) + "]"


def vector_to_insert(key: str, vector,
                     collection: Optional[str] = None) -> str:
    """EMBED STORE statement for one vector."""
    stmt = f"EMBED STORE '{key}' {_fmt_vec(vector)}"
    if collection:
        stmt += f" IN {collection}"
    return stmt


def vectors_to_inserts(keys: Sequence[str], vectors,
                       collection: Optional[str] = None) -> List[str]:
    mat = np.asarray(vectors, dtype=np.float32)
    if mat.ndim != 2 or len(keys) != mat.shape[0]:
        raise NeumannError("keys and vectors must align ([N], [N, d])")
    return [vector_to_insert(k, mat[i], collection)
            for i, k in enumerate(keys)]


def parse_embedding(embedding_str: str) -> np.ndarray:
    """Parse '[0.1, 0.2, ...]' back into an array."""
    s = embedding_str.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise NeumannError(f"not a vector literal: {embedding_str!r}")
    body = s[1:-1].strip()
    if not body:
        return np.zeros(0, np.float32)
    try:
        return np.asarray([float(x) for x in body.split(",")],
                          np.float32)
    except ValueError as e:
        raise NeumannError(f"bad vector literal: {e}") from None


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b / (na * nb))


def euclidean_distance(a, b) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(np.linalg.norm(a - b))


def normalize_vectors(vectors) -> np.ndarray:
    """Row-normalize [N, d] (zero rows stay zero)."""
    mat = np.asarray(vectors, np.float32)
    single = mat.ndim == 1
    if single:
        mat = mat[None, :]
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    out = np.where(norms > 0, mat / np.maximum(norms, 1e-30), 0.0)
    return out[0] if single else out


# -- pandas bridges (optional dependency) ----------------------------------

def _pandas():
    try:
        import pandas as pd
    except ImportError as e:  # pragma: no cover - env without pandas
        raise NeumannError(
            "pandas is not installed; the DataFrame bridges need it"
        ) from e
    return pd


def result_to_dataframe(result):
    """QueryResult/ClientResult rows -> DataFrame."""
    pd = _pandas()
    rows = getattr(result, "rows", None)
    if rows is None:
        rows = result
    return pd.DataFrame(list(rows))


def rows_to_dataframe(rows):
    return result_to_dataframe(rows)


def dataframe_to_inserts(df, table: str) -> List[str]:
    """One INSERT statement per DataFrame row."""
    _pandas()
    cols = list(df.columns)
    out = []
    for _, row in df.iterrows():
        vals = []
        for c in cols:
            v = row[c]
            if v is None or (isinstance(v, float) and np.isnan(v)):
                vals.append("NULL")
            elif isinstance(v, str):
                esc = v.replace("'", "''")
                vals.append(f"'{esc}'")
            elif isinstance(v, (bool, np.bool_)):
                vals.append("TRUE" if v else "FALSE")
            else:
                vals.append(repr(
                    v.item() if isinstance(v, np.generic) else v))
        out.append(f"INSERT INTO {table} ({', '.join(cols)}) "
                   f"VALUES ({', '.join(vals)})")
    return out
