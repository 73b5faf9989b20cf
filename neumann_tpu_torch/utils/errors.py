"""Error hierarchy for neumann_tpu.

Mirrors the capability of the reference's per-crate error enums
(e.g. vector_engine VectorError, relational_engine RelationalError) with a
single Python exception tree.

The port's copy of ``neumann_tpu/utils/errors.py``:
only its import lines differ.
"""


class NeumannError(Exception):
    """Base class for all neumann_tpu errors."""


class StoreError(NeumannError):
    """Tensor store errors (missing key, type mismatch, durability)."""


class ParseError(NeumannError):
    """Query language parse error, with source position."""

    def __init__(self, message: str, line: int = 0, col: int = 0):
        self.line = line
        self.col = col
        if line:
            message = f"{message} (line {line}, col {col})"
        super().__init__(message)


class RelationalError(NeumannError):
    """Relational engine errors (schema, constraint, transaction)."""


class GraphError(NeumannError):
    """Graph engine errors (missing node/edge, invalid traversal)."""


class VectorError(NeumannError):
    """Vector engine errors (dimension mismatch, empty vector, bad top_k)."""


class VaultError(NeumannError):
    """Vault errors (auth, permission, missing secret)."""


class CacheError(NeumannError):
    """LLM cache errors."""


class BlobError(NeumannError):
    """Blob store errors (missing blob, integrity failure)."""


class CheckpointError(NeumannError):
    """Checkpoint/rollback errors."""


class ChainError(NeumannError):
    """Transaction chain / consensus errors."""
