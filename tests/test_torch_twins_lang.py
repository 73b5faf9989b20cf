"""The JAX package's language tests run on the port: tests/test_parser.py,
test_cypher.py, test_parser_cold_grammar.py, test_param_parse.py,
test_reference_grammar.py, test_sql_surface.py,
test_statement_surface.py, test_statement_surface2.py,
test_statement_surface3.py, test_sql_differential.py,
test_sql_differential2.py, test_grammar_fuzz.py, test_native.py and
test_native_parser.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors.

Patched: EXPLAIN SIMILAR ... IN a collection names the port's route
("f32 scan") where the JAX router names the TPU's MXU."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_parser", packages=_PORT))
globals().update(twin_tests("test_cypher", packages=_PORT))
globals().update(twin_tests("test_parser_cold_grammar", packages=_PORT))
globals().update(twin_tests("test_param_parse", packages=_PORT))
globals().update(twin_tests("test_reference_grammar", packages=_PORT))
globals().update(twin_tests("test_sql_surface", packages=_PORT))
globals().update(twin_tests("test_statement_surface", packages=_PORT))
# EXPLAIN names the port's route where the JAX router names the TPU's MXU
globals().update(twin_tests("test_statement_surface2", packages=_PORT,
                            port_patch={'assert any("MXU" in str(row)':
                                        'assert any("f32 scan" in str(row)'}))
globals().update(twin_tests("test_statement_surface3", packages=_PORT))
globals().update(twin_tests("test_sql_differential", packages=_PORT))
globals().update(twin_tests("test_sql_differential2", packages=_PORT))
globals().update(twin_tests("test_grammar_fuzz", packages=_PORT))
globals().update(twin_tests("test_native", packages=_PORT))
globals().update(twin_tests("test_native_parser", packages=_PORT))
