"""tensor_checkpoint parity: named + auto checkpoints with rollback.

The port's copy of ``neumann_tpu/checkpoint/__init__.py``:
only its import lines differ.
"""

from neumann_tpu_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    DESTRUCTIVE_OPS,
)
