"""Chat-template application per model family.

Renders OpenAI-style message lists (+ optional tool schemas) into the token
stream each model family was trained on. With an ``HFTokenizer`` whose
tokenizer ships a chat template, that template wins; otherwise family-specific
string templates are used. The ``ByteTokenizer`` gets a simple marker-based
template that is trivially learnable by test models and unambiguous to parse.
"""

from __future__ import annotations

import json
from typing import Any

from .tokenizer import ByteTokenizer, Tokenizer


def _content_str(msg: dict[str, Any]) -> str:
    c = msg.get("content")
    if c is None:
        if msg.get("tool_calls"):
            return json.dumps({"tool_calls": msg["tool_calls"]}, ensure_ascii=False)
        return ""
    if isinstance(c, str):
        return c
    return json.dumps(c, ensure_ascii=False)


def render_tools_preamble(tools: list[dict[str, Any]] | None) -> str:
    """Inject tool schemas as a system-prompt suffix (model-family agnostic)."""
    if not tools:
        return ""
    lines = [
        "\n\nYou have access to the following functions. To call one, reply "
        "with a JSON object {\"tool_calls\": [{\"id\": \"call_0\", \"type\": "
        "\"function\", \"function\": {\"name\": ..., \"arguments\": "
        "\"<json-encoded args>\"}}]} and nothing else.",
    ]
    for t in tools:
        fn = t.get("function", t)
        lines.append(
            f"- {fn.get('name')}: {fn.get('description', '')} "
            f"parameters schema: {json.dumps(fn.get('parameters', {}), ensure_ascii=False)}"
        )
    return "\n".join(lines)


def render_llama3(messages: list[dict[str, Any]], tools=None) -> str:
    out = ["<|begin_of_text|>"]
    msgs = _merge_tools_into_system(messages, tools)
    for m in msgs:
        role = m.get("role", "user")
        out.append(
            f"<|start_header_id|>{role}<|end_header_id|>\n\n{_content_str(m)}<|eot_id|>"
        )
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def render_qwen(messages: list[dict[str, Any]], tools=None) -> str:
    out = []
    msgs = _merge_tools_into_system(messages, tools)
    for m in msgs:
        role = m.get("role", "user")
        out.append(f"<|im_start|>{role}\n{_content_str(m)}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def _merge_tools_into_system(
    messages: list[dict[str, Any]], tools
) -> list[dict[str, Any]]:
    if not tools:
        return messages
    pre = render_tools_preamble(tools)
    msgs = [dict(m) for m in messages]
    for m in msgs:
        if m.get("role") == "system":
            m["content"] = _content_str(m) + pre
            return msgs
    return [{"role": "system", "content": pre.strip()}] + msgs


def byte_template_ids(
    tok: ByteTokenizer, messages: list[dict[str, Any]], tools=None
) -> list[int]:
    """Marker-token template for the byte tokenizer."""
    role_ids = {
        "system": tok.SYS,
        "user": tok.USER,
        "assistant": tok.ASSISTANT,
        "tool": tok.USER,
    }
    ids: list[int] = [tok.bos_id]
    for m in _merge_tools_into_system(messages, tools):
        ids.append(role_ids.get(m.get("role", "user"), tok.USER))
        ids.extend(tok.encode(_content_str(m)))
        ids.append(tok.END)
    ids.append(tok.ASSISTANT)
    return ids


def apply_chat_template(
    tokenizer: Tokenizer,
    messages: list[dict[str, Any]],
    model_family: str = "",
    tools: list[dict[str, Any]] | None = None,
) -> list[int]:
    """messages -> prompt token ids ready for prefill."""
    if isinstance(tokenizer, ByteTokenizer):
        return byte_template_ids(tokenizer, messages, tools)
    hf = getattr(tokenizer, "hf", None)
    if hf is not None and getattr(hf, "chat_template", None):
        return hf.apply_chat_template(
            _merge_tools_into_system(messages, tools),
            add_generation_prompt=True,
            tokenize=True,
        )
    family = model_family.lower()
    if "qwen" in family or "deepseek" in family:
        text = render_qwen(messages, tools)
    else:
        text = render_llama3(messages, tools)
    return tokenizer.encode(text)
