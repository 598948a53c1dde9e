"""Regenerate this directory's byte-level BPE tokenizer in DeepSeek-V3's
form: ``tokenizer.json``, ``tokenizer_config.json`` and ``expected.json``.

    JAX_PLATFORMS=cpu python tests/fixtures/tiny-bpe-ds/make_tokenizer.py

Trains with the ``tokenizers`` package on the agent corpus (the
conversations of ``scripts/train_tiny_agent.py`` and the ReAct system
prompts, English and Chinese, and a line of accents, digits and emoji),
with DeepSeek-V3's pre-tokenizer: a ``Sequence`` of three ``Isolated``
``Split`` regexes (digit runs of up to three, CJK runs, then words,
punctuation and whitespace with ``\\p{L}``, ``\\p{M}``, ``\\p{P}`` and
``\\p{S}``) before ``ByteLevel(use_regex=false)``, an empty ``Sequence``
normalizer and a ``ByteLevel`` decoder. Added tokens as V3 has them: the
sentence markers and the chat roles special, ``<think>`` and
``</think>`` not special and normalized. The config names bos, eos and pad
only (so the role tokens are not among transformers' special ids) and
carries a chat template in the style of DeepSeek-V2-Chat's (``User:`` /
``Assistant:`` turns, system turns gathered first through
``namespace()``, tool calls and results). ``expected.json`` holds the
prompt ids that the JAX package's ``apply_chat_template`` gives through
``HFTokenizer`` for the messages ``chip_smoke.py``'s ``bpe`` block sends.
Needs ``tokenizers`` and ``transformers``; the port reads the result
without them.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "scripts"), os.path.join(HERE, "..", "tiny-sp")]

from make_tokenizer import corpus, write_expected  # noqa: E402  (tiny-sp's)
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models  # noqa: E402
from tokenizers import normalizers, pre_tokenizers, trainers  # noqa: E402

VOCAB_SIZE = 1024
BOS, EOS, PAD = "<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>", "<｜▁pad▁｜>"
ROLES = ["<｜User｜>", "<｜Assistant｜>", "<｜tool▁calls▁begin｜>", "<｜tool▁calls▁end｜>"]
THINK = ["<think>", "</think>"]
SPLITS = (
    r"\p{N}{1,3}",
    r"[一-龥぀-ゟ゠-ヿ]+",
    r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+|"
    r" ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
)
TEMPLATE = """\
{% if not add_generation_prompt is defined %}{% set add_generation_prompt = false %}{% endif %}
{% set ns = namespace(system_prompt='', is_first_sp=true, is_tool=false) %}
{%- for message in messages %}
    {%- if message['role'] == 'system' %}
        {%- if ns.is_first_sp %}
            {% set ns.system_prompt = ns.system_prompt + message['content'] %}
            {% set ns.is_first_sp = false %}
        {%- else %}
            {% set ns.system_prompt = ns.system_prompt + '\\n\\n' + message['content'] %}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{{ bos_token }}{% if ns.system_prompt %}{{ ns.system_prompt + '\\n\\n' }}{% endif %}
{%- for message in messages %}
    {%- if message['role'] == 'user' %}
        {%- set ns.is_tool = false -%}
        {{ 'User: ' + message['content'] + '\\n\\n' }}
    {%- elif message['role'] == 'assistant' and message['tool_calls'] is defined and message['tool_calls'] %}
        {%- set ns.is_tool = false -%}
        {{ 'Assistant: <｜tool▁calls▁begin｜>' }}
        {%- for tool in message['tool_calls'] %}
            {{- tool['function']['name'] + '\\n' + tool['function']['arguments'] | tojson }}
            {%- if not loop.last %}{{ '\\n' }}{% endif %}
        {%- endfor %}
        {{- '<｜tool▁calls▁end｜>' + eos_token }}
    {%- elif message['role'] == 'assistant' %}
        {%- set ns.is_tool = false -%}
        {{ 'Assistant: ' + message['content'] + eos_token }}
    {%- elif message['role'] == 'tool' %}
        {%- if not ns.is_tool %}{{ 'Tool:' }}{% set ns.is_tool = true %}{% endif %}
        {{- '\\n' + message['content'] + '\\n\\n' }}
    {%- endif %}
{%- endfor %}
{% if add_generation_prompt %}{{ 'Assistant:' }}{% endif %}"""


def main() -> None:
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.normalizer = normalizers.Sequence([])
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [pre_tokenizers.Split(Regex(r), behavior="isolated", invert=False) for r in SPLITS]
        + [pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True,
                                    use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=VOCAB_SIZE, special_tokens=[BOS, EOS, PAD],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(corpus(), trainer)
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in ROLES])
    tok.add_tokens([AddedToken(t, normalized=True, special=False) for t in THINK])
    tok.save(os.path.join(HERE, "tokenizer.json"))
    with open(os.path.join(HERE, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({
            "tokenizer_class": "LlamaTokenizerFast",
            "bos_token": BOS, "eos_token": EOS, "pad_token": EOS, "unk_token": None,
            "add_bos_token": False, "add_eos_token": False, "legacy": True,
            "clean_up_tokenization_spaces": False,
            "chat_template": TEMPLATE,
        }, f, indent=2, ensure_ascii=False)
        f.write("\n")
    write_expected(HERE)


if __name__ == "__main__":
    main()
