"""Cluster-scale audit fan-out: one audit request exploded into N
per-resource agent sessions and reduced back into a single report (the
port's counterpart of ``opsagent_tpu/agent/fanout``).

- ``synthcluster``: deterministic seeded synthetic cluster (namespaces /
  deployments / pods / events) with injected issue archetypes, so tests
  and the card's check score recall against a known ground truth.
- ``orchestrator``: the plan / scatter / reduce pipeline over a fleet
  router — batch-class children sharing one system+context prefix chain,
  Conveyor-style probe launches overlapping each child's decode, and a
  deterministic merge with per-child failure containment.
"""

from .orchestrator import FanoutConfig, FanoutReport, run_audit  # noqa: F401
from .synthcluster import SynthCluster, detect_findings  # noqa: F401
