"""Token accounting: context-window table, message counting, shrinking (the
port's copy of ``opsagent_tpu/llm/tokens.py``).

A static context-window table by model-name prefix (default 4096), message
counting by the OpenAI cookbook's rules, ``constrict_messages`` evicting the
oldest non-system message until the conversation fits, and
``constrict_prompt`` dropping the leading third of the lines until a prompt
fits. Text is counted at four characters a token: the machine beside the
card has no ``tiktoken`` (the JAX package counts this way too when its
encoding cannot be loaded).

``cuda://<name>`` answers with the window of the stack installed under that
name (its engine refuses longer prompts at admission), else of the preset of
that name, else 131072.
"""

from __future__ import annotations

import json
import sys
from typing import Any

# model-name prefix -> context window (tokens)
TOKEN_LIMITS: dict[str, int] = {
    "gpt-4o": 128000,
    "gpt-4-turbo": 128000,
    "gpt-4-32k": 32768,
    "gpt-4": 8192,
    "gpt-3.5-turbo-16k": 16384,
    "gpt-3.5-turbo": 16384,
    "qwen-plus": 131072,
    "qwen-turbo": 131072,
    # Native window (the in-tree presets enforce it at admission; YaRN
    # to 128k is an upstream opt-in config edit).
    "qwen2.5": 32768,
    "deepseek": 65536,
    "llama-3": 8192,
    "llama3": 8192,
    "cuda": 131072,
}

DEFAULT_TOKEN_LIMIT = 4096


def get_token_limits(model: str) -> int:
    m = model.lower()
    if m.startswith("cuda://"):
        # Stacks are installed under any name (cuda://tiny-agent), so the
        # installed-stack registry answers first; but only when the serving
        # module is loaded already: importing it loads torch, and a process
        # that never imported it has no stack installed anyway.
        name = m[len("cuda://"):]
        api_mod = sys.modules.get("opsagent_tpu_torch.serving.api")
        if api_mod is not None:
            installed = api_mod.installed_stack_max_position(name)
            if installed is not None:
                return installed
        from ..models.config import PRESETS

        preset = PRESETS.get(name)
        if preset is not None:
            return preset.max_position
        m = "cuda"
    best = 0
    limit = DEFAULT_TOKEN_LIMIT
    for prefix, window in TOKEN_LIMITS.items():
        if m.startswith(prefix) and len(prefix) > best:
            best = len(prefix)
            limit = window
    return limit


def count_tokens(text: str) -> int:
    """About four characters a token."""
    return max(1, len(text) // 4)


def num_tokens_from_messages(messages: list[dict[str, Any]]) -> int:
    """Count chat tokens per the OpenAI cookbook rules: 3 tokens of overhead
    per message, +1 per name field, +3 for the assistant priming."""
    total = 0
    for msg in messages:
        total += 3
        for key, value in msg.items():
            if isinstance(value, str):
                total += count_tokens(value)
            elif value is not None:
                total += count_tokens(json.dumps(value, ensure_ascii=False))
            if key == "name":
                total += 1
    return total + 3


def constrict_messages(
    messages: list[dict[str, Any]], model: str, max_tokens: int
) -> list[dict[str, Any]]:
    """Evict the oldest non-system messages until the conversation plus the
    reply budget fits the model's context window.

    The system prompt(s) and the LAST message are never evicted: dropping the
    newest turn would send the model a conversation with no question in it.
    """
    limit = get_token_limits(model) - max_tokens
    msgs = list(messages)
    while msgs and num_tokens_from_messages(msgs) > limit:
        evicted = False
        for i, m in enumerate(msgs[:-1]):
            if m.get("role") != "system":
                del msgs[i]
                evicted = True
                break
        if not evicted:
            break
    return msgs


def constrict_prompt(prompt: str, max_tokens: int) -> str:
    """Shrink a prompt to fit ``max_tokens`` by repeatedly dropping the
    leading third of its lines (keeping the tail, where the recent/salient
    output is); at least one line goes each round (the JAX package's loop
    drops none of two lines, and never ends there)."""
    if max_tokens <= 0:
        return ""
    text = prompt
    while text and count_tokens(text) > max_tokens:
        lines = text.splitlines()
        if len(lines) <= 1:
            # Single huge line: cut by characters from the front.
            keep = max(1, len(text) // 3 * 2)
            text = text[-keep:]
            if count_tokens(text) <= max_tokens:
                return text
            # Force convergence on pathological content.
            approx = max_tokens * 4
            return text[-approx:]
        text = "\n".join(lines[max(1, len(lines) // 3):])
    return text
