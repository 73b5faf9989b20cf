"""tensor_vault parity: encrypted secrets with graph-edge ACLs.

The port's copy of ``neumann_tpu/vault/__init__.py``:
only its import lines differ.
"""

from neumann_tpu_torch.vault.anomaly import (  # noqa: F401
    AgentProfile,
    AnomalyEvent,
    AnomalyMonitor,
    AnomalyThresholds,
)
from neumann_tpu_torch.vault.attenuation import (  # noqa: F401
    AttenuationPolicy,
    ExponentialAttenuationPolicy,
)
from neumann_tpu_torch.vault.pki import CertInfo, PkiEngine  # noqa: F401
from neumann_tpu_torch.vault.placement import (  # noqa: F401
    ManifoldPlacer,
    PlacementConfig,
    PlacementRecommendation,
    VaultRegion,
)
from neumann_tpu_torch.vault.scoped import (  # noqa: F401
    DelegationRecord,
    DynamicSecretMeta,
    ImpactReport,
    PasswordConfig,
    RotationPlan,
    ScopedVault,
    SecretTemplate,
    WeightedImpactReport,
    WrappingToken,
)
from neumann_tpu_torch.vault.sync import (  # noqa: F401
    FileSyncTarget,
    GeoCoordinate,
    GeoRouter,
    MemorySyncTarget,
    RoutingConfig,
    SyncTarget,
    TargetGeometry,
    VaultSync,
)
from neumann_tpu_torch.vault.intel import (  # noqa: F401
    AccessTensor,
    AccessTopology,
    AccessTensorConfig,
    GraphIntel,
    HeatKernelTrust,
    SecretSimilarity,
    SecurityAudit,
)
from neumann_tpu_torch.vault.obfuscation import ObfuscationLayer  # noqa: F401
from neumann_tpu_torch.vault.policy import PolicyEngine, PolicyTemplate  # noqa: F401
from neumann_tpu_torch.vault.quota import QuotaManager, ResourceQuota  # noqa: F401
from neumann_tpu_torch.vault.rotation import (  # noqa: F401
    RotationManager,
    RotationPolicy,
)
from neumann_tpu_torch.vault.access import (  # noqa: F401
    AccessController,
    EdgeSigner,
)
from neumann_tpu_torch.vault.vault import TensorVault, Permission  # noqa: F401
