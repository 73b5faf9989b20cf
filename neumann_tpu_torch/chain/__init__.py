"""Distributed layer: blockchain-structured log, Raft, 2PC, gossip.

Capability parity with tensor_chain (~85K LoC Rust): the local chain
(blocks linked by hash with state roots, delta embeddings and signatures),
semantic conflict detection over transaction delta vectors, Tensor-Raft
replication, two-phase commit for cross-shard transactions, SWIM gossip
membership, hybrid logical clocks, deadlock detection, and a cluster
orchestrator. All consensus cores are sans-IO deterministic state
machines (tick/handle -> messages), so the reference's DST/Jepsen-style
testing maps onto seeded in-process simulation with MemoryTransport
fault injection (network.rs:981-1283 capability).

The port's copy of ``neumann_tpu/chain/__init__.py``:
only its import lines differ.
"""

from neumann_tpu_torch.chain.hlc import HLC, HLCTimestamp  # noqa: F401
from neumann_tpu_torch.chain.transport import (  # noqa: F401
    MemoryTransport,
    Message,
    TransportHub,
)
from neumann_tpu_torch.chain.block import Block, Chain  # noqa: F401
from neumann_tpu_torch.chain.consensus import (  # noqa: F401
    ConflictClass,
    ConsensusConfig,
    classify_conflict,
    classify_pairwise,
)
from neumann_tpu_torch.chain.tensor_chain import TensorChain  # noqa: F401
from neumann_tpu_torch.chain.raft import RaftConfig, RaftNode  # noqa: F401
from neumann_tpu_torch.chain.two_phase import (  # noqa: F401
    TwoPhaseCoordinator,
    TwoPhaseParticipant,
)
from neumann_tpu_torch.chain.gossip import GossipNode  # noqa: F401
from neumann_tpu_torch.chain.deadlock import DeadlockDetector  # noqa: F401
from neumann_tpu_torch.chain.sequence import (  # noqa: F401
    SequenceTracker,
    SequenceTrackerConfig,
)
from neumann_tpu_torch.chain.transport import PeerRateLimiter  # noqa: F401
