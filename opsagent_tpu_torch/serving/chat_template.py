"""Chat-template application per model family (the port's copy of
``opsagent_tpu/serving/chat_template.py``).

Renders OpenAI-style message lists (+ optional tool schemas) into the token
stream each model family was trained on. A tokenizer that carries a chat
template (``BPETokenizer.chat_template``, the checkpoint's own Jinja
template) is rendered through it in the environment ``transformers`` gives
a template, as the JAX package renders it through
``hf.apply_chat_template``; otherwise ChatML (``render_qwen``) for Qwen and
DeepSeek, the Llama-3 header template for the rest. The ``ByteTokenizer``
gets a simple marker-based template that is trivially learnable by test
models and unambiguous to parse.
"""

from __future__ import annotations

import functools
import json
from datetime import datetime
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


def _tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
    """transformers' ``tojson`` filter: no HTML escaping, its options."""
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                      sort_keys=sort_keys)


def _strftime_now(fmt: str) -> str:
    return datetime.now().strftime(fmt)


@functools.cache
def compile_template(template: str):
    """The template compiled as ``transformers`` compiles a chat template:
    jinja2's ``ImmutableSandboxedEnvironment`` with ``trim_blocks``,
    ``lstrip_blocks`` and loop controls; its ``tojson`` filter and its
    ``raise_exception`` and ``strftime_now`` globals; ``{% generation %}``
    blocks render their body. jinja2 comes with PyTorch; a machine without
    it cannot render the template, and that raises."""
    try:
        import jinja2
        from jinja2.ext import Extension, loopcontrols
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise RuntimeError("this tokenizer carries a chat template, and rendering it "
                           "needs jinja2, which is not installed") from e

    class Generation(Extension):
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(("name:endgeneration",), drop_needle=True)
            return jinja2.nodes.CallBlock(self.call_method("_body"), [], [], body).set_lineno(
                lineno)

        def _body(self, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[Generation, loopcontrols])
    env.filters["tojson"] = _tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = _strftime_now
    return env.from_string(template)


def render_template(tokenizer, messages: list[dict[str, Any]]) -> str:
    """The tokenizer's chat template over ``messages`` with the generation
    prompt: the variables ``transformers`` passes (``messages``, ``tools``
    and ``documents`` None, ``add_generation_prompt``, the config's special
    tokens). Of several named templates the "default" one is taken, as
    with no tools; a template that fails to render raises."""
    template = tokenizer.chat_template
    if isinstance(template, dict):
        if "default" not in template:
            raise ValueError("this tokenizer has several chat templates and no default: "
                             f"{sorted(template)}")
        template = template["default"]
    return compile_template(template).render(
        messages=messages, tools=None, documents=None, add_generation_prompt=True,
        **tokenizer.template_specials)


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
    if getattr(tokenizer, "chat_template", None):
        return tokenizer.encode(render_template(tokenizer,
                                                _merge_tools_into_system(messages, tools)))
    family = model_family.lower()
    if "qwen" in family or "deepseek" in family:
        text = render_qwen(messages, tools)
    else:
        text = render_llama3(messages, tools)
    return tokenizer.encode(text)
