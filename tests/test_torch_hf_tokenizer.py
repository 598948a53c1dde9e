"""The port's tokenizer and chat-template path of a real checkpoint against
the JAX package's ``HFTokenizer`` path (``transformers``), on the CPU.

Three tokenizer directories:

- ``tests/fixtures/tiny-sp``: the SentencePiece form Mistral and Llama-2
  ship (``Prepend`` / ``Replace`` normalizer, ``byte_fallback`` over 256
  ``<0xNN>`` pieces, a ``Replace`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip`` decoder) with a Mistral-style ``[INST]`` template;
- ``tests/fixtures/tiny-bpe-ds``: DeepSeek-V3's form (three ``Split``
  regexes before ``ByteLevel``; role tokens special but not named by the
  config, normalized ``<think>`` tokens) with a ``User:`` / ``Assistant:``
  template over ``namespace()``;
- a copy of ``tests/fixtures/tiny-bpe`` given a Qwen2.5-style template
  here (a default system prompt, a tools branch).

``encode``, ``decode``, ``token_str``, ``token_bytes``, the vocab size and
the special ids equal ``HFTokenizer``'s over a corpus of ASCII, Chinese,
emoji, accents, digit and whitespace runs and text with added tokens
inside; the ``apply_chat_template`` ids equal JAX's for each template with
and without tools, with and without a system turn, over tool-call and
tool-result turns; a template that raises raises in both; the ToolPrompt
schema's FSM tables through each fixture equal JAX's. The test imports
``tokenizers`` and ``transformers``; the port imports neither.
"""

import dataclasses
import json
import os
import shutil
import sys

import jinja2
import numpy as np
import pytest
import transformers.utils.chat_template_utils as hf_template_utils
from tokenizers import Tokenizer

from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.chat_template import apply_chat_template as jax_template
from opsagent_tpu.serving.tokenizer import HFTokenizer
from opsagent_tpu_torch.serving import chat_template as pct
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.chat_template import apply_chat_template
from opsagent_tpu_torch.serving.tokenizer import BPETokenizer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
# Qwen2.5-Instruct's template, as published, with its default system prompt.
QWEN25_TEMPLATE = """\
{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\nYou may call one or more functions to assist with the user query.\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""
CORPUS = [
    "Hello world",
    "kubectl get pods -n kube-system --output=json | jq '.items[].metadata.name'",
    "你好世界，这是一个测试。日本語のテキストも。한국어 텍스트",
    "emoji 🚀✨👍🏽 👨‍👩‍👧 🇯🇵 ok",
    "Café déjà vu: naïve façade, Ünïcödé, é é (e + combining), ß, Ω≈ç√",
    "12345 67890 3.14159 1e-9 0x1F 1,000,000 ٣٤٥ ⅣⅫ ²³ 0000000000",
    "  leading and trailing   \t\t tabs\n\n\nnewlines\r\n crlf   \n  x  ",
    "It's, we'll, they're; don't 'quote' — «guillemets» ¿qué? ¡sí!",
    "[INST] list the pods [/INST] ok</s><s>[TOOL_CALLS] x",
    "<｜begin▁of▁sentence｜>User: hi<think>plan</think> <｜User｜>x<｜end▁of▁sentence｜>",
    "<|im_start|>system\nYou are helpful.<|im_end|>\n<|im_start|>user\nhi<|im_end|>\n",
    '{"thought": "check pods", "action": {"name": "kubectl", "input": "get po"}}',
    "x",
    "",
]
KUBECTL = [{"type": "function", "function": {
    "name": "kubectl", "description": "run a kubectl command",
    "parameters": {"type": "object", "properties": {"command": {"type": "string"}}}}}]
MESSAGES = {
    "user": [{"role": "user", "content": "list the pods, 请"}],
    "system_user": [{"role": "system", "content": "You are an ops agent."},
                    {"role": "user", "content": "list the pods, 请"}],
    "multi_turn": [{"role": "system", "content": "You are an ops agent."},
                   {"role": "user", "content": "hi"},
                   {"role": "assistant", "content": "  Hello! "},
                   {"role": "user", "content": "count namespaces"}],
    # The tool turns of test_torch_bpe.py::test_chat_template_ids_equal_jax.
    "tool_turns": [{"role": "system", "content": "You are an ops agent."},
                   {"role": "user", "content": "list the pods, 请"},
                   {"role": "assistant", "content": None,
                    "tool_calls": [{"function": {"name": "kubectl", "arguments": "{}"}}]},
                   {"role": "tool", "content": "pod-1 Running"}],
    # The same with the 9-character call ids Mistral's template asks for.
    "tool_turns_ids": [{"role": "user", "content": "list the pods"},
                       {"role": "assistant", "content": None,
                        "tool_calls": [{"id": "call00001", "function": {
                            "name": "kubectl", "arguments": "{\"command\": \"get po\"}"}}]},
                       {"role": "tool", "tool_call_id": "call00001",
                        "content": "pod-1 Running"}],
}


def _qwen_copy(path: str) -> str:
    """tiny-bpe with a Qwen2.5-style template in its config."""
    os.makedirs(path, exist_ok=True)
    shutil.copy(os.path.join(FIXTURES, "tiny-bpe", "tokenizer.json"), path)
    with open(os.path.join(FIXTURES, "tiny-bpe", "tokenizer_config.json"), encoding="utf-8") as f:
        config = json.load(f)
    config["chat_template"] = QWEN25_TEMPLATE
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f)
    return path


@pytest.fixture(scope="module", params=["tiny-sp", "tiny-bpe-ds", "tiny-bpe-qwen"])
def pair(request, tmp_path_factory):
    """(directory, JAX's HFTokenizer, the port's BPETokenizer)."""
    if request.param == "tiny-bpe-qwen":
        path = _qwen_copy(str(tmp_path_factory.mktemp("qwen")))
    else:
        path = os.path.join(FIXTURES, request.param)
    return path, HFTokenizer(path), BPETokenizer(path)


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_encode_decode_equal_hf_tokenizer(pair, i):
    path, hf, ours = pair
    text = CORPUS[i]
    want = hf.encode(text)
    assert ours.encode(text) == want
    assert want == Tokenizer.from_file(os.path.join(path, "tokenizer.json")).encode(
        text, add_special_tokens=False).ids
    assert ours.decode(want) == hf.decode(want)


def test_decode_of_token_slices_equals_hf_tokenizer(pair):
    """Slices that cut multi-byte characters and byte-fallback runs decode
    to the same replacement characters; special tokens are skipped."""
    _, hf, ours = pair
    ids = hf.encode("".join(CORPUS))
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = sorted(rng.integers(0, len(ids) + 1, 2).tolist())
        assert ours.decode(ids[a:b]) == hf.decode(ids[a:b])


def test_vocab_specials_token_str_and_bytes_equal_hf_tokenizer(pair):
    _, hf, ours = pair
    assert (ours.vocab_size, ours.bos_id, ours.eos_id, ours.pad_id) == (
        hf.vocab_size, hf.bos_id, hf.eos_id, hf.pad_id)
    V = ours.vocab_size
    assert [ours.token_str(i) for i in range(V)] == [hf.token_str(i) for i in range(V)]
    assert [ours.token_bytes(i) for i in range(V)] == [hf.token_bytes(i) for i in range(V)]
    assert ours.token_bytes(V) == b"" and ours.token_str(V) == ""
    assert ours.template_specials == hf.hf.special_tokens_map


def test_decode_cleans_up_spaces_where_the_config_says_so(tmp_path):
    """``clean_up_tokenization_spaces`` in the config: decode drops the
    space before punctuation and contractions, as transformers' decode
    does; off (every fixture), the text is the decoder's."""
    path = _with_config(tmp_path, "clean", clean_up_tokenization_spaces=True)
    hf, ours = HFTokenizer(path), BPETokenizer(path)
    for text in ("it 's , we 're . why ? no ! don 't", *CORPUS):
        ids = hf.encode(text)
        assert ours.decode(ids) == hf.decode(ids)
    ids = hf.encode("a , b .")
    assert ours.decode(ids) == "a, b."


def test_token_bytes_follow_jax_rule_on_sentencepiece_pieces():
    """JAX's rule on a SentencePiece vocab, kept as it is: ``é`` is in the
    GPT-2 byte map, so it gives the byte 0xE9, not its UTF-8; ``<0x0A>`` is
    six characters of the map, so it gives those six; ``▁`` is a space;
    the config's specials give b"", a control token it does not name its
    text."""
    path = os.path.join(FIXTURES, "tiny-sp")
    hf, ours = HFTokenizer(path), BPETokenizer(path)
    ids = {ours.token_str(i): i for i in range(ours.vocab_size)}
    assert ours.token_bytes(ids["é"]) == hf.token_bytes(ids["é"]) == b"\xe9"
    assert ours.token_bytes(ids["<0x0A>"]) == hf.token_bytes(ids["<0x0A>"]) == b"<0x0A>"
    piece = next(s for s in ids if s.startswith("\u2581") and len(s) > 3)
    assert ours.token_bytes(ids[piece]) == hf.token_bytes(ids[piece]) == (
        " " + piece[1:]).encode()
    assert ours.token_bytes(ids["<s>"]) == hf.token_bytes(ids["<s>"]) == b""
    # Special in tokenizer.json but not named by the config: its text.
    assert ours.token_bytes(ids["[INST]"]) == hf.token_bytes(ids["[INST]"]) == b"[INST]"


def test_role_tokens_not_named_by_the_config_have_bytes():
    """A special added token the config does not name is not among
    transformers' special ids: its token bytes are its UTF-8 in both, and
    decode still skips it."""
    path = os.path.join(FIXTURES, "tiny-bpe-ds")
    hf, ours = HFTokenizer(path), BPETokenizer(path)
    (user,) = ours.encode("<｜User｜>")
    assert ours.token_bytes(user) == hf.token_bytes(user) == "<｜User｜>".encode()
    assert ours.decode([user]) == hf.decode([user]) == ""


@pytest.mark.parametrize("tools", [None, KUBECTL], ids=["no_tools", "tools"])
@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_chat_template_ids_equal_jax(pair, case, tools):
    """The tokenizer's own template, rendered and encoded, gives JAX's
    ids whatever the family; where it raises (Mistral's role order and
    tool-call ids), it raises in both with the same message."""
    _, hf, ours = pair
    messages = MESSAGES[case]
    try:
        want = jax_template(hf, messages, "qwen2.5-7b-instruct", tools)
    except jinja2.TemplateError as e:
        with pytest.raises(jinja2.TemplateError) as got:
            apply_chat_template(ours, messages, "qwen2.5-7b-instruct", tools)
        assert str(got.value) == str(e)
        return
    for family in ("qwen2.5-7b-instruct", "bench-8b", "deepseek-v2-lite"):
        assert apply_chat_template(ours, messages, family, tools) == want


def test_templates_are_the_fixtures_own():
    """A tokenizer with a template is never rendered as ChatML or Llama-3
    headers: tiny-sp's prompt opens with ``<s>[INST]``, tiny-bpe-ds's with
    its bos and ``User:``, and the Qwen copy's carries the default system
    prompt that ChatML alone lacks."""
    messages = [{"role": "user", "content": "hi"}]
    sp = BPETokenizer(os.path.join(FIXTURES, "tiny-sp"))
    ids = apply_chat_template(sp, messages, "qwen2.5-7b-instruct")
    assert ids[:2] == [sp.bos_id, sp.encode("[INST]")[0]]
    ds = BPETokenizer(os.path.join(FIXTURES, "tiny-bpe-ds"))
    assert ds.decode(apply_chat_template(ds, messages, "bench-8b")).startswith("User: hi")
    for name in ("tiny-sp", "tiny-bpe-ds"):
        with open(os.path.join(FIXTURES, name, "expected.json"), encoding="utf-8") as f:
            expected = json.load(f)
        tok = BPETokenizer(os.path.join(FIXTURES, name))
        assert apply_chat_template(tok, expected["messages"], "bench-8b") == \
            expected["prompt_ids"]
        assert os.path.getsize(os.path.join(FIXTURES, name, "tokenizer.json")) < 100_000


def test_qwen_template_adds_its_default_system_prompt(tmp_path):
    path = _qwen_copy(str(tmp_path / "q"))
    ours, hf = BPETokenizer(path), HFTokenizer(path)
    got = ours.decode(apply_chat_template(ours, MESSAGES["user"], "qwen2.5"))
    assert "You are Qwen" in got
    assert len(apply_chat_template(ours, MESSAGES["user"], "qwen2.5")) == len(
        jax_template(hf, MESSAGES["user"], "qwen2.5")) > len(
        apply_chat_template(BPETokenizer(os.path.join(FIXTURES, "tiny-bpe")),
                            MESSAGES["user"], "qwen2.5"))


def _with_config(tmp_path, name: str, **change) -> str:
    path = tmp_path / name
    shutil.copytree(os.path.join(FIXTURES, "tiny-sp"), path)
    with open(path / "tokenizer_config.json", encoding="utf-8") as f:
        config = json.load(f)
    config.update(change)
    with open(path / "tokenizer_config.json", "w", encoding="utf-8") as f:
        json.dump(config, f)
    return str(path)


def test_strftime_now_renders_pinned_in_both(tmp_path, monkeypatch):
    """A template that calls ``strftime_now`` (Llama-3.1's date line) with
    the clock pinned in both packages."""
    import datetime as dt

    class Pinned(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 10, 18, 12, 0, 0)

    monkeypatch.setattr(hf_template_utils, "datetime", Pinned)
    monkeypatch.setattr(pct, "datetime", Pinned)
    template = ("{{ bos_token }}Today Date: {{ strftime_now('%d %b %Y') }}\n"
                "{% for m in messages %}{{ m['role'] }}: {{ m['content'] }}\n{% endfor %}"
                "{% if add_generation_prompt %}assistant:{% endif %}")
    path = _with_config(tmp_path, "dated", chat_template=template)
    ours, hf = BPETokenizer(path), HFTokenizer(path)
    got = apply_chat_template(ours, MESSAGES["user"])
    assert got == jax_template(hf, MESSAGES["user"])
    assert "18 Oct 2026" in ours.decode(got)


def test_named_templates_and_template_files_as_transformers_reads_them(tmp_path):
    """A list of named templates takes "default" (JAX passes no tools); a
    ``chat_template.jinja`` beside the config wins over the config's; named
    files with no default raise in both."""
    named = [{"name": "default", "template": "{% for m in messages %}D:{{ m.content }}"
                                             "{% endfor %}"},
             {"name": "tool_use", "template": "T:{{ messages[0].content }}"}]
    path = _with_config(tmp_path, "named", chat_template=named)
    ours, hf = BPETokenizer(path), HFTokenizer(path)
    assert apply_chat_template(ours, MESSAGES["user"], "", KUBECTL) == jax_template(
        hf, MESSAGES["user"], "", KUBECTL)
    assert ours.decode(apply_chat_template(ours, MESSAGES["user"])).startswith("D:")
    path = _with_config(tmp_path, "file")
    with open(os.path.join(path, "chat_template.jinja"), "w", encoding="utf-8") as f:
        f.write("F:{{ messages[-1]['content'] }}{{ eos_token }}")
    ours, hf = BPETokenizer(path), HFTokenizer(path)
    assert apply_chat_template(ours, MESSAGES["user"]) == jax_template(hf, MESSAGES["user"])
    assert ours.decode(apply_chat_template(ours, MESSAGES["user"])).startswith("F:")
    os.remove(os.path.join(path, "chat_template.jinja"))
    os.makedirs(os.path.join(path, "additional_chat_templates"))
    with open(os.path.join(path, "additional_chat_templates", "rag.jinja"), "w",
              encoding="utf-8") as f:
        f.write("R:{{ messages[0].content }}")
    ours, hf = BPETokenizer(path), HFTokenizer(path)
    with pytest.raises(ValueError, match="no default"):
        jax_template(hf, MESSAGES["user"])
    with pytest.raises(ValueError, match="no default"):
        apply_chat_template(ours, MESSAGES["user"])


@pytest.mark.parametrize("template,error", [
    ("{{ raise_exception('no system role') }}", jinja2.TemplateError),
    ("{% for m in messages %}{{ m.content | no_such_filter }}{% endfor %}",
     jinja2.TemplateError),
    ("{{ messages.__class__.__mro__ }}", jinja2.TemplateError),
])
def test_a_template_that_fails_raises_in_both(tmp_path, template, error):
    """No fallback to ChatML: a template that fails to render raises, as
    JAX's does (the sandbox refuses attribute access it does not allow)."""
    path = _with_config(tmp_path, "bad", chat_template=template)
    with pytest.raises(error):
        jax_template(HFTokenizer(path), MESSAGES["user"])
    with pytest.raises(error):
        apply_chat_template(BPETokenizer(path), MESSAGES["user"])


def test_a_template_without_jinja2_raises(tmp_path, monkeypatch):
    """Where jinja2 is missing, a tokenizer with a template raises with a
    message; it is never rendered as ChatML."""
    path = _with_config(tmp_path, "nojinja", chat_template="N:{{ messages[0].content }}")
    monkeypatch.setitem(sys.modules, "jinja2", None)
    pct.compile_template.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="jinja2"):
            apply_chat_template(BPETokenizer(path), MESSAGES["user"], "qwen2.5")
    finally:
        pct.compile_template.cache_clear()


@pytest.mark.parametrize("name", ["tiny-sp", "tiny-bpe-ds"])
def test_toolprompt_fsm_tables_equal_jax(name):
    """The FSM tables are built from token_bytes: through each fixture
    they equal the JAX package's."""
    path = os.path.join(FIXTURES, name)
    want = jc.json_constraint(HFTokenizer(path), jc.TOOLPROMPT_SCHEMA).fsm.dense_tables()
    got = pc.json_constraint(BPETokenizer(path), pc.TOOLPROMPT_SCHEMA).fsm.dense_tables()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["tiny-sp", "tiny-bpe-ds"])
def test_templated_json_schema_tokens_equal_jax_engine(name):
    """The slice end to end on a tiny-test model over the fixture's vocab
    (same weights): the templated prompt, then greedy json_schema tokens
    through the port's engine with the FSM built from its token bytes,
    against the JAX engine with ``HFTokenizer``."""
    import jax
    import jax.numpy as jnp
    import torch

    from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
    from opsagent_tpu.serving.engine import Engine as JaxEngine
    from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
    from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
    from opsagent_tpu_torch.models.config import TINY_TEST
    from opsagent_tpu_torch.models.convert import params_from_jax
    from opsagent_tpu_torch.models.llama import Llama
    from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
    from opsagent_tpu_torch.serving.sampler import SamplingParams

    schema = {"type": "object", "properties": {"name": {"enum": ["kubectl", "trivy"]},
                                               "ok": {"type": "boolean"}}}
    kw = dict(page_size=8, num_pages=256, max_pages_per_seq=32, max_batch_size=2)
    path = os.path.join(FIXTURES, name)
    hf, tok = HFTokenizer(path), BPETokenizer(path)
    V = tok.vocab_size
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(64,), **kw),
                     model_cfg=dataclasses.replace(JAX_TINY, vocab_size=V), tokenizer=hf)
    cfg = dataclasses.replace(TINY_TEST, vocab_size=V)
    model = Llama(cfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), cfg))
    messages = [{"role": "system", "content": "Reply in JSON."},
                {"role": "user", "content": "pick a tool"}]
    prompt = apply_chat_template(tok, messages, "bench-8b")
    assert prompt == jax_template(hf, messages, "bench-8b")
    sid = jeng.begin_request(prompt, JaxSamplingParams(max_tokens=48),
                             mask_fn=jc.json_constraint(hf, schema))
    while not jeng.prefill_step(sid):
        pass
    while not jeng.sequences[sid].done:
        jeng.step_block([sid])
    want = jeng.finish(sid)
    eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                              decode_block=8, **kw), model_cfg=cfg, model=model, tokenizer=tok)
    got = eng.generate([prompt], SamplingParams(max_tokens=48),
                       mask_fn=[pc.json_constraint(tok, schema)])[0]
    assert got == want
    assert json.loads(tok.decode(got[:-1] if got[-1] == tok.eos_id else got))["name"] in (
        "kubectl", "trivy")
