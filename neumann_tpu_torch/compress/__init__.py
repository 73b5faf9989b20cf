"""tensor_compress parity: TT decomposition, streaming TT archive,
varint/delta/RLE codecs.

The port's copy of ``neumann_tpu/compress/__init__.py``: only its import
lines differ.
"""

from neumann_tpu_torch.compress.tensor_train import (  # noqa: F401
    TTConfig,
    TTVector,
    tt_cosine_similarity,
    tt_decompose,
    tt_dot,
    tt_reconstruct,
)
from neumann_tpu_torch.compress.codecs import (  # noqa: F401
    delta_decode_ids,
    delta_encode_ids,
    rle_decode,
    rle_encode,
    varint_decode,
    varint_encode,
)
from neumann_tpu_torch.compress.streaming_tt import (  # noqa: F401
    StreamingTTWriter,
    stream_dense,
    stream_tt,
)
