"""The port's vault (neumann_tpu_torch/vault/, copies of the JAX
package's modules with only their import lines changed) against the
JAX package's, on the CPU.

Every scenario of the JAX vault tests runs on both packages as one test
parametrised over ``package`` (tests/torch_twins.py): the vault cases of
tests/test_extended_modules.py (secrets, ACLs, versions, namespaces, rate
limits, Shamir, point-in-time snapshots, anomalies, PKI, sync and geo
routing, scoped vaults, a PKI-issued certificate over the chain's TLS
transport) and tests/test_vault_access.py,
test_vault_depth.py, test_vault_intel.py and test_vault_scoped_depth.py.
Then a vault sealed by the JAX package is opened by the port from the
same store snapshot, and the reverse, and the routers' VAULT statements
give equal results. The vault needs ``cryptography``; the router
imports it only in ``init_vault`` (tests/test_torch_nojax.py).
"""

import pytest

from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.store.tensor_store import TensorStore as JStore
from neumann_tpu.vault import TensorVault as JVault
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.store.tensor_store import TensorStore as TStore
from neumann_tpu_torch.utils.errors import VaultError as TVaultError
from neumann_tpu_torch.vault import TensorVault as TVault
from tests.test_torch_relational import run_both
from tests.torch_twins import twin_tests

_EXTENDED_VAULT = (
    "test_vault_roundtrip_and_wrong_password", "test_vault_acl_levels_and_ttl",
    "test_vault_versions_rollback_audit", "test_vault_namespaces_and_list",
    "test_vault_rate_limit", "test_shamir_split_combine", "test_shamir_errors",
    "test_vault_pitr_snapshots", "test_vault_pitr_non_root_denied",
    "test_vault_pitr_survives_reopen", "test_vault_anomaly_monitor",
    "test_vault_anomaly_wired_and_persisted",
    "test_pki_ca_issue_verify_revoke_crl",
    "test_pki_issued_cert_works_for_tls_transport", "test_vault_sync_targets",
    "test_geo_router_route_exclude_ema", "test_vault_sync_geo_routed_fanout",
    "test_scoped_lifecycle_and_delegation",
    "test_scoped_wrapping_and_dependencies", "test_scoped_dynamic_secrets")

globals().update(twin_tests("test_extended_modules", _EXTENDED_VAULT))
for _module in ("test_vault_access", "test_vault_depth", "test_vault_intel",
                "test_vault_scoped_depth"):
    globals().update(twin_tests(_module))


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_a_vault_opens_across_packages(tmp_path, sealer):
    """Secrets, grants and versions written by one package's vault are
    read by the other's from the same snapshot bytes; a wrong password
    fails on both."""
    make = {"jax": (JStore, JVault), "port": (TStore, TVault)}
    store_cls, vault_cls = make[sealer]
    other_store, other_vault = make["port" if sealer == "jax" else "jax"]
    store = store_cls()
    v = vault_cls(store, "hunter2")
    v.set("db/password", "s3cret")
    v.set("db/password", "s3cret-2")
    v.set("api/key", "k-123")
    v.grant("alice", "api/key")
    path = tmp_path / "vault.ntpu"
    store.save_snapshot(path)
    fresh = other_store()
    fresh.load_snapshot(path)
    w = other_vault(fresh, "hunter2")
    assert w.get("db/password") == "s3cret-2"
    assert w.get("api/key", actor="alice") == "k-123"
    assert sorted(w.list("*")) == sorted(v.list("*"))
    assert w.versions("db/password") == v.versions("db/password")
    w.rollback_version("db/password")
    assert w.get("db/password") == "s3cret"
    with pytest.raises(Exception) as err:
        other_vault(fresh, "wrong").get("api/key")
    assert type(err.value).__name__ == "VaultError"


def test_vault_statements_match_jax():
    """VAULT statements through a JAX and a port router: equal results,
    errors of the same class (the audit log's timestamps aside)."""
    jr, tr = JRouter(), TRouter(device="cpu")
    run_both(jr, tr, "VAULT GET 'x'")           # not initialised
    jr.init_vault("pw")
    tr.init_vault("pw")
    for stmt in ("VAULT SET 'db/pw' 'one'", "VAULT GET 'db/pw'",
                 "VAULT ROTATE 'db/pw' 'two'", "VAULT GET 'db/pw'",
                 "VAULT HISTORY 'db/pw'", "VAULT ROLLBACK 'db/pw'",
                 "VAULT GET 'db/pw'", "VAULT SET 'api/key' 'k'",
                 "VAULT LIST", "VAULT LIST 'db/*'",
                 "VAULT GRANT 'bob' ON 'api/key'",
                 "VAULT REVOKE 'bob' ON 'api/key'",
                 "VAULT DELETE 'api/key'", "VAULT DELETE 'api/key'",
                 "VAULT GET 'api/key'", "VAULT SEAL", "VAULT GET 'db/pw'",
                 "VAULT UNSEAL 'pw'", "VAULT GET 'db/pw'",
                 "VAULT ROTATE MASTER 'pw2'", "VAULT GET 'db/pw'"):
        run_both(jr, tr, stmt)
    got = tr.execute("VAULT AUDIT 5").rows
    want = jr.execute("VAULT AUDIT 5").rows
    assert [{k: v for k, v in r.items() if k != "ts"} for r in got] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in want]
    with pytest.raises(TVaultError):
        TVault(TStore(), "pw").get("nope")
