"""tensor_blob parity: content-addressed chunked object storage.

The port's copy of ``neumann_tpu/blob/__init__.py``:
only its import lines differ.
"""

from neumann_tpu_torch.blob.blob_store import BlobStore, BlobWriter  # noqa: F401
