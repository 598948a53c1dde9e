"""The five workflows (the port's copy of
``opsagent_tpu/workflows/flows.py``).
"""

from __future__ import annotations

from ..agent.funcall import (
    kubectl_function,
    trivy_function,
    run_function_agent,
)
from ..agent.react import assistant_with_config
from ..agent.prompts import (
    ANALYSIS_PROMPT,
    AUDIT_PROMPT,
    GENERATE_PROMPT,
    ASSISTANT_PROMPT,
    ASSISTANT_PROMPT_CN,
)
from ..llm.client import ChatClient, new_client_from_env

MAX_TURNS = 30


def analysis_flow(model: str, manifest: str, client: ChatClient | None = None) -> str:
    """Analyze a Kubernetes manifest (single-step flow, kubectl available)."""
    client = client or new_client_from_env()
    user_input = f"Analyze this Kubernetes manifest:\n\n```yaml\n{manifest}\n```"
    result, _ = run_function_agent(
        client,
        model,
        ANALYSIS_PROMPT,
        user_input,
        [kubectl_function()],
        max_turns=MAX_TURNS,
    )
    return result


def audit_flow(
    model: str, pod: str, namespace: str = "default", client: ChatClient | None = None
) -> str:
    """Security-audit a Pod: manifest review + trivy image scanning."""
    client = client or new_client_from_env()
    user_input = f"Audit the Pod '{pod}' in namespace '{namespace}'."
    result, _ = run_function_agent(
        client,
        model,
        AUDIT_PROMPT,
        user_input,
        [kubectl_function(), trivy_function()],
        max_turns=MAX_TURNS,
    )
    return result


def generator_flow(model: str, prompt: str, client: ChatClient | None = None) -> str:
    """Generate Kubernetes manifests (pure generation, no tools)."""
    client = client or new_client_from_env()
    result, _ = run_function_agent(
        client,
        model,
        GENERATE_PROMPT,
        prompt,
        [],
        max_turns=1,
    )
    return result


def assistant_flow(model: str, instructions: str, client: ChatClient | None = None) -> str:
    """Generic instruction-following flow with kubectl available."""
    client = client or new_client_from_env()
    result, _ = run_function_agent(
        client,
        model,
        ASSISTANT_PROMPT,
        instructions,
        [kubectl_function()],
        max_turns=MAX_TURNS,
    )
    return result


def assistant_flow_with_config(
    model: str,
    instructions: str,
    api_key: str = "",
    base_url: str = "",
) -> tuple[str, list[dict]]:
    """ReAct-loop variant with per-request credentials (2048 tokens a
    turn, 10 iterations, the Chinese assistant prompt)."""
    messages = [
        {"role": "system", "content": ASSISTANT_PROMPT_CN},
        {"role": "user", "content": instructions},
    ]
    return assistant_with_config(
        model,
        messages,
        max_tokens=2048,
        count_tokens=True,
        verbose=False,
        max_iterations=10,
        api_key=api_key,
        base_url=base_url,
    )
