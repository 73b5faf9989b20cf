"""The JAX package's op tests run on the port's ``ops/``:
tests/test_ops_scan.py, test_pooled_scan.py, test_rerank.py and
test_batched_fused.py, their ``jax.numpy`` inputs made as CPU tensors.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors.

Patched, TPU-only machinery: ``topk_scan(..., selection="approx")``
(``lax.approx_max_k``) is the port's exact selection;
``_pick_pool_blocks`` is the port's ``_pick_pool`` over one block (the
port scans the corpus in one launch); ``_batched_core``'s argument
errors are ``batched_ivf_topk``'s (the port has no ``group``);
``batched_probe_pallas`` is the port's ``kernels.batched_probe`` (its
plain version on the CPU). Left out: test_pooled_scan.py's three
``TestApproxSelector`` tests of ``selector="approx"``, a cut the port
does not have (torch has no ``approx_max_k``; its exact cut keeps every
candidate the approximate one would).

Not twinned anywhere, with reasons: tests/test_pallas_kernels.py (the
JAX package's Pallas kernels in interpret mode; the port's CUDA kernels
are held to them in tests/test_torch_kernels.py and
tests/test_torch_quant.py) and tests/test_compile_cache.py (XLA's
persistent compilation cache, ROADMAP item 13: the port compiles no
XLA)."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

_IVF = "__import__('neumann_tpu_torch.ops.ivf', fromlist=['x'])"

# the port selects exactly where JAX can cut with lax.approx_max_k
globals().update(twin_tests(
    "test_ops_scan", packages=_PORT, torch_jnp=True, port_patch={
    'selection="approx", recall_target=0.95)': ")"}))
# the port scans the corpus in one launch: its _pick_pool gives the pool,
# and the rows are one block
globals().update(twin_tests(
    "test_pooled_scan", packages=_PORT, torch_jnp=True, port_patch={
    "'_pick_pool_blocks', ": "'_pick_pool', ",
    "class TestPickPoolBlocks:":
        "_pick_pool = _pick_pool_blocks\n\n\n"
        "def _pick_pool_blocks(n, k, pool, block_rows):\n"
        "    p = _pick_pool(n, k, pool)\n"
        "    return None if p is None else (p, n // p, 1)\n\n\n"
        "class TestPickPoolBlocks:",
}, leave_out=("TestApproxSelector.test_top_rows_survive_the_cut",
              "TestApproxSelector.test_scores_and_rows_decode_identically",
              "TestApproxSelector.test_rerank_chain_accepts_selector")))
globals().update(twin_tests("test_rerank", packages=_PORT, torch_jnp=True))
globals().update(twin_tests(
    "test_batched_fused", packages=_PORT, torch_jnp=True, port_patch={
    "_batched_core = _ops_import('neumann_tpu_torch.ops.ivf', "
    "'_batched_core')":
        "_batched_core = (lambda m, nprobe, window, q_cap, group, *a: "
        f"{_IVF}.batched_ivf_topk(None, None, None, None, None, nprobe, "
        "window, m, q_cap, None, *a))",
    "_ops_import('neumann_tpu_torch.ops.pallas_kernels', "
    "'batched_probe_pallas', 'decode_strided_pool_bits')":
        "_ops_import('neumann_tpu_torch.ops.kernels', 'batched_probe', "
        "'decode_strided_pool_bits')",
}))
