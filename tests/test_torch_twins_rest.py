"""The rest of the JAX test files twinned in part elsewhere (the tests of
tests/test_parallel.py, test_coverage_gaps.py, test_integration_parity.py,
test_memory_temporal.py, test_entrypoints.py, test_store.py and
test_stress.py that no other twin file runs) on the port alone.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port"s card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors; test_parallel.py"s ``jnp`` makes CPU
tensors.

Patched: test_entrypoints.py"s loader test makes the port"s native
loaders find no built library through ``pathlib.Path.exists`` (they do
not use ``os.path``); test_store.py"s view test reads the port"s tensor
dtypes (``torch.int8``, and sign bits packed as int32 where the JAX
slab keeps uint32: torch has no uint32 bit ops). Left out:
test_coverage_gaps.py::test_package_lazy_helpers, which tests the JAX
package"s own ``neumann_tpu._lazy`` / ``open_shell`` helpers (the port
opens its shell with ``python -m neumann_tpu_torch.shell``).
"""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests(
    "test_parallel", ("test_kmeans_device_balance",), packages=_PORT,
    torch_jnp=True))
globals().update(twin_tests(
    "test_coverage_gaps", (
        "test_condition_expr_serialization_roundtrip",
        "test_condition_to_dict_roundtrip_all_ops",
        "test_condition_expr_tree_dict",
        "test_wal_python_fallback_decode",
        "test_wal_unencodable_put_raises",
        "test_wal_manual_mode_ram_bound",
        "test_async_retry_backoff",
    ), packages=_PORT))
globals().update(twin_tests(
    "test_integration_parity", (
        "test_knn_cold_read",
        "test_delete_consistency_across_engines",
        "test_blob_embedding_search",
        "test_cache_invalidation",
        "test_cache_ttl_expiry_on_get",
        "test_durable_store_auto_init_and_reopen",
        "test_grand_unification_flow",
        "test_cache_background_eviction",
        "test_cache_metric_configuration",
        "test_cache_auto_selects_jaccard_for_sparse",
        "test_tcp_node_cas_over_real_sockets",
        "test_rest_hostile_inputs",
    ), packages=_PORT))
globals().update(twin_tests(
    "test_memory_temporal", (
        "TestTemporal.test_autocorrelation_and_period",
        "TestTemporal.test_drift",
        "TestTemporal.test_seasonal_daily_rhythm",
        "TestTemporal.test_burst_detection",
        "TestTemporal.test_too_few_buckets",
        "TestTemporal.test_vault_integration",
        "TestTemporalMath.test_autocorrelation_exact_value",
        "TestTemporalMath.test_period_two_detected",
        "TestTemporalMath.test_drift_exact_rates",
        "TestTemporalMath.test_config_frozen_reports",
        "TestTemporalMath.test_bucketize_span",
        "TestMutationKills.test_autocorrelation_vs_numpy_oracle",
    ), packages=_PORT))
globals().update(twin_tests(
    "test_entrypoints", (
        "test_shell_main_module",
        "test_native_loader_no_toolchain_fallback",
    ), packages=_PORT, port_patch={
        """monkeypatch.setattr(
            mod.os.path, "exists", lambda p: False)""":
        """monkeypatch.setattr(
            __import__("pathlib").Path, "exists", lambda p: False)"""}))
globals().update(twin_tests(
    "test_store", (
        "test_put_get_delete",
        "test_scan_prefix",
        "test_empty_key_rejected",
        "test_value_model",
        "test_from_embedding_auto",
        "test_sparse_ops",
        "test_snapshot_roundtrip",
        "test_wal_replay",
        "test_wal_torn_tail",
        "test_wal_group_commit",
        "test_checkpoint_truncates_wal",
        "test_entity_index",
        "test_embedding_slab",
        "test_embedding_slab_growth",
        "test_embedding_slab_dim_mismatch",
        "test_quantized_views",
        "test_compressed_snapshot_roundtrip",
        "test_sparse_weighted_jaccard",
        "test_snapshot_corruption_hardening",
        "test_codec_native_python_byte_identical",
        "test_codec_cross_decode",
        "test_wal_cross_implementation",
        "test_snapshot_cross_implementation",
        "test_codec_native_error_mapping",
        "test_ordered_index_newline_keys",
        "test_store_newline_keys_roundtrip",
        "test_native_codec_corruption_fuzz",
    ), packages=_PORT, port_patch={
        'assert q.dtype.name == "int8"': 'assert str(q.dtype) == "torch.int8"',
        'assert bits.dtype.name == "uint32"':
        'assert str(bits.dtype) == "torch.int32"'}))
globals().update(twin_tests(
    "test_stress", (
        "test_store_concurrent_put_get_delete",
        "test_vector_engine_concurrent_store_and_search",
        "test_relational_concurrent_inserts",
        "test_graph_concurrent_node_edge_churn",
        "test_wal_concurrent_writers",
    ), packages=_PORT))
