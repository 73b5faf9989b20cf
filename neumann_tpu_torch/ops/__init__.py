"""Device compute of the port: the exact scan, int8 quantization, the
two hand-written CUDA kernels (``kernels.py``), the exact rerank and
the windowed IVF index. Modules import torch; kernels build on first
use, never at import."""
