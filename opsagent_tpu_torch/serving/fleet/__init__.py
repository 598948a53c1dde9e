"""Fleet serving (the port's counterpart of ``opsagent_tpu/serving/fleet``):
replica registry, prefix-affinity router, and session migration over KV-page
transfer.

Modules:

- ``registry``  — replica self-registration (capacity, mesh shape, role,
  health, prefix-trie digest), heartbeat + liveness reaping, drain state.
- ``router``    — the front-end: speaks the engine-server API, places
  sessions by prefix-affinity first / least-loaded-goodput second with
  sticky pinning, bounded queue spill-over, and graceful replica drain;
  its HTTP app runs on the standard library's ``ThreadingHTTPServer``.
- ``transfer``  — replica-to-replica KV-page shipping using the host
  pool's token-chain keys as the wire format (byte-compatible with the JAX
  package's), so the receiving engine restores instead of re-prefilling
  exactly like a local host-tier hit.
- ``client``    — the replica-side membership client (``serve-engine
  --join-fleet``): register, heartbeat, drain state for /healthz.
- ``pagestore`` — fleet-global KV: the heartbeat digests indexed into a
  chain->owners directory, plus the peer-to-peer page fault-in client
  that turns an admission miss into a wire restore instead of a
  re-prefill (tier order: HBM trie -> host pool -> peer fetch ->
  re-prefill).

- ``autoscale`` — elastic scale-out: shed pressure launches standby
  replicas restored from a snapshot (``SubprocessLauncher``), promoted once
  request-ready; idle scaler-launched replicas retire through the drain.
"""

from .pagestore import (  # noqa: F401
    PageDirectory,
    PageStoreClient,
    http_client,
    local_client,
)
from .registry import ReplicaInfo, ReplicaRegistry  # noqa: F401
from .router import (  # noqa: F401
    FleetRouter,
    LocalReplica,
    build_router_app,
    run_router_server,
)
from .transfer import migrate_chain, pack_entries, unpack_entries  # noqa: F401
