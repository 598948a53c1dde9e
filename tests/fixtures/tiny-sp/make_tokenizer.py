"""Regenerate this directory's SentencePiece-style BPE tokenizer, in the form
Mistral and Llama-2 ship: ``tokenizer.json``, ``tokenizer_config.json`` and
``expected.json``.

    JAX_PLATFORMS=cpu python tests/fixtures/tiny-sp/make_tokenizer.py

Trains a BPE with the ``tokenizers`` package on the agent corpus (the
conversations of ``scripts/train_tiny_agent.py`` and the ReAct system
prompts, English and Chinese, and a line of accents, digits and emoji),
pieces cut at spaces as SentencePiece cuts them. The file then takes
Llama-2's form: ids 0-2 ``<unk>``, ``<s>``, ``</s>``; 3-9 Mistral's control
tokens (``[INST]`` ...); 10-265 the 256 ``<0xNN>`` byte pieces; then the
trained pieces. A ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizer, no
pre-tokenizer, ``byte_fallback`` with ``<unk>`` fused, and a ``Replace`` /
``ByteFallback`` / ``Fuse`` / ``Strip`` decoder. The config carries a chat
template in the style of Mistral-7B-Instruct-v0.3's (``[INST]`` turns, the
system prompt folded into the last user turn, ``raise_exception`` on the
role order and on tool-call ids). ``expected.json`` holds the prompt ids
that the JAX package's ``apply_chat_template`` gives through
``HFTokenizer`` for the messages ``chip_smoke.py``'s ``bpe`` block sends.
Needs ``tokenizers`` and ``transformers``; the port reads the result
without them.
"""

import json
import os
import sys
import tempfile
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]

from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers  # noqa: E402
from tokenizers import pre_tokenizers, trainers  # noqa: E402
from train_tiny_agent import build_convs  # noqa: E402

from opsagent_tpu.agent.prompts import (  # noqa: E402
    DIAGNOSE_SYSTEM_PROMPT,
    EXECUTE_SYSTEM_PROMPT_CN,
    REACT_SYSTEM_PROMPT,
)

TRAINED = 640  # pieces learned beyond the specials and the byte pieces
ALPHABET = 120  # characters that are pieces; the rest fall back to bytes
SPECIALS = ["<unk>", "<s>", "</s>"]
CONTROL = ["[INST]", "[/INST]", "[TOOL_CALLS]", "[AVAILABLE_TOOLS]", "[/AVAILABLE_TOOLS]",
           "[TOOL_RESULTS]", "[/TOOL_RESULTS]"]
BYTES = [f"<0x{b:02X}>" for b in range(256)]
EXTRA = (REACT_SYSTEM_PROMPT, EXECUTE_SYSTEM_PROMPT_CN, DIAGNOSE_SYSTEM_PROMPT,
         "Café déjà vu: naïve façade, 12345 pods, 3.14 GiB, ünïcödé; 你好世界 🚀✨ "
         "It's, we'll, they're, I'd, you've, I'm.")
# The bpe block's request in chip_smoke.py.
BPE_MESSAGES = [{"role": "user", "content": "Pick a tool and say if it is ok."}]
TEMPLATE = """\
{%- if messages[0]["role"] == "system" %}
    {%- set system_message = messages[0]["content"] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}
{%- set user_messages = loop_messages | selectattr("role", "equalto", "user") | list %}

{#- Roles alternate user/assistant, tool turns aside #}
{%- set ns = namespace() %}
{%- set ns.index = 0 %}
{%- for message in loop_messages %}
    {%- if not (message.role == "tool" or (message.tool_calls is defined and message.tool_calls)) %}
        {%- if (message["role"] == "user") != (ns.index % 2 == 0) %}
            {{- raise_exception("After the optional system message, conversation roles must alternate user/assistant/user/assistant/...") }}
        {%- endif %}
        {%- set ns.index = ns.index + 1 %}
    {%- endif %}
{%- endfor %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if message["role"] == "user" %}
        {%- if tools is not none and (message == user_messages[-1]) %}
            {{- "[AVAILABLE_TOOLS] " + tools | tojson + "[/AVAILABLE_TOOLS]" }}
        {%- endif %}
        {%- if loop.last and system_message is defined %}
            {{- "[INST] " + system_message + "\\n\\n" + message["content"] + "[/INST]" }}
        {%- else %}
            {{- "[INST] " + message["content"] + "[/INST]" }}
        {%- endif %}
    {%- elif message.tool_calls is defined and message.tool_calls %}
        {{- "[TOOL_CALLS] [" }}
        {%- for tool_call in message.tool_calls %}
            {%- set out = tool_call.function | tojson %}
            {{- out[:-1] }}
            {%- if not tool_call.id is defined or tool_call.id | length != 9 %}
                {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
            {%- endif %}
            {{- ', "id": "' + tool_call.id + '"}' }}
            {%- if not loop.last %}
                {{- ", " }}
            {%- else %}
                {{- "]" + eos_token }}
            {%- endif %}
        {%- endfor %}
    {%- elif message["role"] == "assistant" %}
        {{- " " + message["content"] | trim + eos_token }}
    {%- elif message["role"] == "tool" %}
        {{- '[TOOL_RESULTS] {"content": ' + message.content | string + ", " }}
        {%- if not message.tool_call_id is defined or message.tool_call_id | length != 9 %}
            {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
        {%- endif %}
        {{- '"call_id": "' + message.tool_call_id + '"}[/TOOL_RESULTS]' }}
    {%- else %}
        {{- raise_exception("Only user and assistant roles are supported, with the exception of an initial optional system message!") }}
    {%- endif %}
{%- endfor %}
"""


def corpus() -> list[str]:
    out = list(EXTRA)
    for messages, reply in build_convs():
        out += [m["content"] for m in messages] + [reply]
    return out


def main() -> None:
    texts = corpus()
    # The most frequent characters, ties by code point: the trainer's own
    # cut breaks ties in no fixed order.
    counts = Counter("".join("▁" + t.replace(" ", "▁") for t in texts))
    alphabet = sorted(counts, key=lambda c: (-counts[c], c))[:ALPHABET]
    trainer_tok = Tokenizer(models.BPE(unk_token="<unk>"))
    trainer_tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    trainer = trainers.BpeTrainer(vocab_size=TRAINED + 3, special_tokens=SPECIALS,
                                  initial_alphabet=alphabet, limit_alphabet=ALPHABET,
                                  show_progress=False)
    trainer_tok.train_from_iterator(texts, trainer)
    with tempfile.TemporaryDirectory() as tmp:
        trainer_tok.save(os.path.join(tmp, "trained.json"))
        with open(os.path.join(tmp, "trained.json"), encoding="utf-8") as f:
            trained = json.load(f)["model"]
    vocab = {tok: i for i, tok in enumerate(SPECIALS + CONTROL + BYTES)}
    for tok, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(tok, len(vocab))
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in trained["merges"]]
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in SPECIALS + CONTROL])
    tok.save(os.path.join(HERE, "tokenizer.json"))
    with open(os.path.join(HERE, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({
            "tokenizer_class": "LlamaTokenizerFast",
            "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": None,
            "add_bos_token": True, "add_eos_token": False, "legacy": True,
            "clean_up_tokenization_spaces": False,
            "chat_template": TEMPLATE,
        }, f, indent=2, ensure_ascii=False)
        f.write("\n")
    write_expected(HERE)


def write_expected(here: str) -> None:
    """The JAX package's prompt ids for the bpe block's messages."""
    from opsagent_tpu.serving.chat_template import apply_chat_template
    from opsagent_tpu.serving.tokenizer import HFTokenizer

    ids = apply_chat_template(HFTokenizer(here), BPE_MESSAGES)
    with open(os.path.join(here, "expected.json"), "w", encoding="utf-8") as f:
        json.dump({"messages": BPE_MESSAGES, "prompt_ids": list(ids)}, f, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    main()
