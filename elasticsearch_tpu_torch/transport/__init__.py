"""Control-plane transport: action-dispatched RPC between nodes.

The reference's transport layer (transport/TransportService.java:72,
TcpTransport.java:96) is a framed binary RPC with handlers registered by
action name. Here the control plane (cluster state, membership, recovery)
runs host-side over this abstraction — the data plane is XLA collectives
inside pjit programs (parallel/) — mirroring the reference's typed-channel
split (SURVEY.md §5.8).
"""

from elasticsearch_tpu_torch.transport.scheduler import (
    Cancellable, DeterministicScheduler, Scheduler, ThreadedScheduler,
)
from elasticsearch_tpu_torch.transport.transport import (
    ConnectTransportError, InMemoryTransport, NodeNotConnectedError,
    ReceiveTimeoutError, RemoteTransportError, TransportService,
)

__all__ = [
    "Cancellable", "DeterministicScheduler", "Scheduler", "ThreadedScheduler",
    "ConnectTransportError", "InMemoryTransport", "NodeNotConnectedError",
    "ReceiveTimeoutError", "RemoteTransportError", "TransportService",
]
