"""Workflow layer: task-shaped flows over the function-calling agent (the
port's copy of ``opsagent_tpu/workflows``): ``analysis_flow``,
``audit_flow``, ``generator_flow``, ``assistant_flow`` and
``assistant_flow_with_config`` (the ReAct loop with the assistant
prompt).
"""

from .flows import (
    analysis_flow,
    audit_flow,
    generator_flow,
    assistant_flow,
    assistant_flow_with_config,
)

__all__ = [
    "analysis_flow",
    "audit_flow",
    "generator_flow",
    "assistant_flow",
    "assistant_flow_with_config",
]
