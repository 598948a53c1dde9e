"""Deterministic synthetic Kubernetes cluster with injected issues (the
port's copy of ``opsagent_tpu/agent/fanout/synthcluster.py``, byte for
byte in what it generates).

The fan-out subsystem needs a cluster it can audit end to end where the
RIGHT answer is known in advance: tests assert recall == 1.0 against the
injected issues and byte-identical reduce reports across runs, and the
card's ``fanout`` check scores a real fleet serving workload against the
same ground truth. Everything here is a pure function of ``(resources, seed,
issue_fraction)`` — same inputs, same pods, same evidence text, same
ground truth — so two audits of the same cluster must agree to the byte.

Four issue archetypes are injected, each with evidence shaped like the
``kubectl describe pod`` output a real probe would return:

========== ========== ==========================================
archetype  severity   evidence signature
========== ========== ==========================================
oomkill    critical   ``Last State: Terminated / Reason: OOMKilled``
crashloop  high       ``Waiting / Reason: CrashLoopBackOff`` + back-off
privileged high       ``securityContext: privileged: true``
bad_probe  medium     ``Readiness probe failed`` warning events
========== ========== ==========================================

``detect_findings`` is the deterministic rule layer over that evidence:
the schema-constrained LLM decode is the serving workload the fan-out
measures, while the findings that score recall come from rules a random
-weight test checkpoint cannot get wrong.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any

# Closed severity enum: the opsagent_fanout_findings_total label and the
# reduce sort both key on it (metrics cardinality guard rejects strays).
SEVERITIES = (
    "critical", "high", "medium", "low", "none", "unavailable",
)

ISSUE_SEVERITY = {
    "oomkill": "critical",
    "crashloop": "high",
    "privileged": "high",
    "bad_probe": "medium",
}

_NAMESPACES = (
    "payments", "search", "ingest", "auth", "billing", "media",
    "edge", "mlserve",
)
_APPS = ("api", "worker", "gateway", "cache", "indexer", "relay")
_IMAGES = (
    "registry.local/app:v1.42", "registry.local/app:v1.43",
    "registry.local/sidecar:v0.9", "registry.local/base:v2.1",
)
_SUFFIX = "abcdefhkmnpqrstvwxz246789"  # k8s-ish pod hash alphabet


def severity_rank(severity: str) -> int:
    """Stable sort key: most severe first, unknown values last."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        return len(SEVERITIES)


@dataclass(frozen=True)
class PodSpec:
    namespace: str
    deployment: str
    name: str
    node: str
    image: str
    restarts: int
    issue: str | None  # archetype key, or None for a healthy pod

    @property
    def resource(self) -> str:
        return f"{self.namespace}/{self.name}"


class SynthCluster:
    """Seeded synthetic cluster inventory + per-resource probe evidence."""

    def __init__(
        self,
        resources: int = 64,
        seed: int = 0,
        issue_fraction: float = 0.25,
    ):
        if resources < 1:
            raise ValueError("resources must be >= 1")
        self.resources = int(resources)
        self.seed = int(seed)
        self.issue_fraction = float(issue_fraction)
        rng = random.Random(f"synthcluster:{self.seed}")
        archetypes = sorted(ISSUE_SEVERITY)
        n_issues = min(
            self.resources,
            max(1, round(self.resources * self.issue_fraction)),
        )
        bad = set(rng.sample(range(self.resources), n_issues))
        nodes = [f"node-{i:02d}" for i in range(max(2, self.resources // 16))]
        pods: list[PodSpec] = []
        seen: set[str] = set()
        issue_i = 0
        for i in range(self.resources):
            ns = _NAMESPACES[i % len(_NAMESPACES)]
            app = rng.choice(_APPS)
            dep = f"{ns}-{app}"
            while True:
                name = (
                    f"{app}-{''.join(rng.choices(_SUFFIX, k=5))}"
                    f"-{''.join(rng.choices(_SUFFIX, k=5))}"
                )
                if f"{ns}/{name}" not in seen:
                    break
            seen.add(f"{ns}/{name}")
            issue = None
            if i in bad:
                issue = archetypes[issue_i % len(archetypes)]
                issue_i += 1
            pods.append(PodSpec(
                namespace=ns,
                deployment=dep,
                name=name,
                node=rng.choice(nodes),
                image=rng.choice(_IMAGES),
                restarts=(
                    rng.randint(7, 99) if issue == "crashloop"
                    else rng.randint(0, 2)
                ),
                issue=issue,
            ))
        self.pods = pods
        self._by_resource = {p.resource: p for p in pods}

    # -- inventory (the shared audit context) -------------------------------
    def inventory_text(self) -> str:
        """One compact line for the shared prompt prefix: deliberately a
        SUMMARY, not the pod list — the per-resource detail arrives via
        the probe, so the shared prefix stays identical for every child."""
        namespaces = sorted({p.namespace for p in self.pods})
        return (
            f"Cluster synth-{self.seed}: {len(self.pods)} pods across "
            f"{len(namespaces)} namespaces ({', '.join(namespaces)})."
        )

    def work_items(self) -> list[str]:
        """Per-resource audit shards, in a deterministic order."""
        return [p.resource for p in self.pods]

    # -- ground truth -------------------------------------------------------
    def ground_truth(self) -> list[dict[str, Any]]:
        """The injected issues as finding rows, reduce-sorted."""
        rows = [
            {
                "resource": p.resource,
                "issue": p.issue,
                "severity": ISSUE_SEVERITY[p.issue],
            }
            for p in self.pods if p.issue is not None
        ]
        rows.sort(key=lambda f: (
            severity_rank(f["severity"]), f["resource"], f["issue"],
        ))
        return rows

    # -- probe evidence -----------------------------------------------------
    def describe(self, resource: str) -> str:
        """``kubectl describe pod``-shaped evidence for one resource —
        what the child's Conveyor probe returns mid-decode."""
        p = self._by_resource.get(resource)
        if p is None:
            return f'Error from server (NotFound): pod "{resource}" not found'
        lines = [
            f"Name:         {p.name}",
            f"Namespace:    {p.namespace}",
            f"Node:         {p.node}",
            f"Controlled By: Deployment/{p.deployment}",
            "Containers:",
            "  main:",
            f"    Image:         {p.image}",
            f"    Restart Count: {p.restarts}",
        ]
        if p.issue == "privileged":
            lines += [
                "    Security Context:",
                "      privileged: true",
                "    State:          Running",
            ]
        elif p.issue == "crashloop":
            lines += [
                "    State:          Waiting",
                "      Reason:       CrashLoopBackOff",
                "    Last State:     Terminated",
                "      Reason:       Error",
                "      Exit Code:    1",
            ]
        elif p.issue == "oomkill":
            lines += [
                "    State:          Running",
                "    Last State:     Terminated",
                "      Reason:       OOMKilled",
                "      Exit Code:    137",
            ]
        else:
            lines += ["    State:          Running"]
        lines += ["Conditions:", "  Ready  " + (
            "False" if p.issue in ("crashloop", "bad_probe") else "True"
        ), "Events:"]
        if p.issue == "crashloop":
            lines.append(
                "  Warning  BackOff  Back-off restarting failed container "
                f"main in pod {p.name}"
            )
        elif p.issue == "oomkill":
            lines.append(
                "  Warning  Evicted  container main exceeded its memory "
                "limit"
            )
        elif p.issue == "bad_probe":
            lines.append(
                "  Warning  Unhealthy  Readiness probe failed: HTTP probe "
                "failed with statuscode: 503"
            )
        else:
            lines.append("  <none>")
        return "\n".join(lines)


def detect_findings(evidence: str, resource: str) -> list[dict[str, Any]]:
    """Deterministic triage rules over probe evidence. Ordered by the
    evidence signature's specificity; one finding per matched archetype."""
    out: list[dict[str, Any]] = []

    def add(issue: str, detail: str) -> None:
        out.append({
            "resource": resource,
            "issue": issue,
            "severity": ISSUE_SEVERITY[issue],
            "detail": detail,
        })

    if "Reason:       OOMKilled" in evidence or "Exit Code:    137" in evidence:
        add("oomkill", "container terminated by the OOM killer (exit 137)")
    if "CrashLoopBackOff" in evidence or "Back-off restarting" in evidence:
        add("crashloop", "container in restart back-off")
    if "privileged: true" in evidence:
        add("privileged", "container runs with privileged security context")
    if "probe failed" in evidence.lower():
        add("bad_probe", "readiness/liveness probe failing")
    return out
