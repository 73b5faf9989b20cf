"""The JAX package's store, shell and server-side tests run on the port:
tests/test_ordered_index.py (both of its fixture's implementations),
test_wal_overlay.py, test_snapshot_buffer.py, test_cursor_store.py,
test_shell.py, test_shell_wal_themes.py, test_gamification.py,
test_web_admin.py and test_docs_examples.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors.

A ``Shell`` the tests make runs over a CPU router."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_ordered_index", packages=_PORT))
globals().update(twin_tests("test_wal_overlay", packages=_PORT))
globals().update(twin_tests("test_snapshot_buffer", packages=_PORT))
globals().update(twin_tests("test_cursor_store", packages=_PORT))
globals().update(twin_tests("test_shell", packages=_PORT))
globals().update(twin_tests("test_shell_wal_themes", packages=_PORT))
globals().update(twin_tests("test_gamification", packages=_PORT))
globals().update(twin_tests("test_web_admin", packages=_PORT))
globals().update(twin_tests("test_docs_examples", packages=_PORT))
