"""Device compute of the port: the exact scan, int8 quantization, the
two hand-written CUDA kernels (``kernels.py``), the exact rerank and
the windowed IVF index. Modules import torch; kernels build on first
use, never at import."""

from neumann_tpu_torch.ops.scan import (  # noqa: F401
    METRICS,
    host_pull,
    topk_scan,
    score_all,
)
from neumann_tpu_torch.ops.quant import (  # noqa: F401
    scalar_quantize,
    scalar_dequantize,
    binary_quantize,
    hamming_topk,
    int8_topk_scan,
    int8_pooled_topk,
    int8_cosine_row_mult,
)
