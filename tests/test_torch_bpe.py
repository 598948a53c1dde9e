"""The port's byte-level-BPE reader (``BPETokenizer``) against the
``tokenizers`` library and the JAX package's ``HFTokenizer``, on the CPU.

Three tokenizers: the fixture ``tests/fixtures/tiny-bpe`` (a bare
``ByteLevel`` pre-tokenizer with GPT-2's pattern, made by
``scripts/train_tiny_agent.py``'s ``train_bpe_tokenizer`` plus the ChatML
specials), and two trained here in process over the same corpus with the
Llama-3 and Qwen2 form, ``Sequence[Split(Regex), ByteLevel(use_regex=
false)]`` (Qwen2's with an NFC normalizer, Llama-3's with
``ignore_merges``). ``encode`` and ``decode`` equal ``tokenizers``' over a
corpus of ASCII, the ReAct prompts, CJK, accents, digits, emoji,
whitespace runs, contractions and specials; ``token_bytes``, ``token_str``
and the special ids equal ``HFTokenizer``'s over the whole vocab; the
ToolPrompt schema's dense tables over the fixture equal the JAX package's;
greedy json_schema tokens through the port's engine with the fixture
equal the JAX engine's with ``HFTokenizer``. The test imports
``tokenizers`` and ``transformers``; the port imports neither.
"""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

from opsagent_tpu.agent.prompts import (
    DIAGNOSE_SYSTEM_PROMPT,
    EXECUTE_SYSTEM_PROMPT_CN,
    REACT_SYSTEM_PROMPT,
)
from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.chat_template import apply_chat_template as jax_template
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.tokenizer import HFTokenizer
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.chat_template import apply_chat_template
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.tokenizer import (
    BPETokenizer,
    ByteTokenizer,
    load_tokenizer,
    translate_pattern,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tiny-bpe")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CORPUS = [
    "Hello world",
    "kubectl get pods -n kube-system --output=json | jq '.items[].metadata.name'",
    REACT_SYSTEM_PROMPT,
    EXECUTE_SYSTEM_PROMPT_CN,
    DIAGNOSE_SYSTEM_PROMPT,
    "你好世界，这是一个测试。日本語のテキストも。한국어 텍스트",
    "Café déjà vu: naïve façade, Ünïcödé, ÅÆØ åæø, ñ, ß, é (combining), Ω≈ç√",
    "12345 67890 3.14159 1e-9 0x1F 1,000,000 ٣٤٥ ⅣⅫ ²³",
    "emoji 🚀✨👍🏽 👨‍👩‍👧 🇯🇵 ok",
    "  leading and trailing   \t\t tabs\n\n\nnewlines\r\n crlf   \n  x  ",
    "It's, we'll, they're, I'd, you've, I'm; IT'S WE'LL THEY'RE; don't 'quote' ''",
    "<|im_start|>system\nYou are helpful.<|im_end|>\n<|im_start|>user\nhi<|im_end|>\n"
    "<|im_start|>assistant\n",
    "<|endoftext|><|im_end|><|im_start|><bos>x<eos> <pad>",
    "ſ K \x1c\x1d\x1e\x1f   　 x​y",
    '{"thought": "check pods", "action": {"name": "kubectl", "input": "get po"}}',
    "",
]


def _train(kind: str) -> Tokenizer:
    """A byte-level BPE trained in process with the Llama-3 or Qwen2
    pre-tokenizer, 640 tokens, the fixture's specials."""
    pattern = QWEN2_PATTERN if kind == "qwen2" else LLAMA3_PATTERN
    tok = Tokenizer(models.BPE(unk_token=None, ignore_merges=kind == "llama3"))
    if kind == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=640, show_progress=False,
        special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(CORPUS * 3, trainer)
    return tok


@pytest.fixture(scope="module", params=["fixture", "qwen2", "llama3"])
def pair(request, tmp_path_factory):
    """(tokenizers' Tokenizer, the port's BPETokenizer of the same file)."""
    if request.param == "fixture":
        return Tokenizer.from_file(os.path.join(FIXTURE, "tokenizer.json")), BPETokenizer(FIXTURE)
    tok = _train(request.param)
    path = tmp_path_factory.mktemp(request.param)
    tok.save(str(path / "tokenizer.json"))
    return tok, BPETokenizer(str(path))


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_encode_decode_equal_tokenizers(pair, i):
    hf, ours = pair
    text = CORPUS[i]
    want = hf.encode(text, add_special_tokens=False).ids
    assert ours.encode(text) == want
    assert ours.decode(want) == hf.decode(want, skip_special_tokens=True)


def test_decode_of_token_slices_equals_tokenizers(pair):
    """Slices that cut multi-byte characters decode to the same
    replacement characters."""
    hf, ours = pair
    ids = hf.encode("".join(CORPUS), add_special_tokens=False).ids
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = sorted(rng.integers(0, len(ids) + 1, 2).tolist())
        assert ours.decode(ids[a:b]) == hf.decode(ids[a:b], skip_special_tokens=True)


def test_token_strings_equal_tokenizers(pair):
    hf, ours = pair
    assert ours.vocab_size == hf.get_vocab_size(with_added_tokens=True)
    assert [ours.token_str(i) for i in range(ours.vocab_size)] == [
        hf.id_to_token(i) for i in range(ours.vocab_size)]


@pytest.fixture(scope="module")
def hf_fixture():
    return HFTokenizer(FIXTURE)


def test_fixture_ids_and_token_bytes_equal_hf_tokenizer(hf_fixture):
    ours = BPETokenizer(FIXTURE)
    assert (ours.vocab_size, ours.bos_id, ours.eos_id, ours.pad_id) == (
        hf_fixture.vocab_size, hf_fixture.bos_id, hf_fixture.eos_id, hf_fixture.pad_id)
    assert ours.eos_id == ours.encode("<|im_end|>")[0]
    V = ours.vocab_size
    assert [ours.token_bytes(i) for i in range(V)] == [hf_fixture.token_bytes(i)
                                                       for i in range(V)]
    assert [ours.token_str(i) for i in range(V)] == [hf_fixture.token_str(i) for i in range(V)]
    assert ours.token_bytes(V) == b"" and ours.token_str(V) == ""
    for text in CORPUS:
        assert ours.encode(text) == hf_fixture.encode(text)
        assert ours.decode(ours.encode(text)) == hf_fixture.decode(hf_fixture.encode(text))


def test_fixture_is_small_and_has_the_chatml_specials():
    assert os.path.getsize(os.path.join(FIXTURE, "tokenizer.json")) < 300_000
    tok = BPETokenizer(FIXTURE)
    for name in ("<|im_start|>", "<|im_end|>", "<|endoftext|>"):
        (tid,) = tok.encode(name)
        assert tok.token_bytes(tid) == b"" and tok.decode([tid]) == ""


def test_toolprompt_tables_equal_jax(hf_fixture):
    ours = BPETokenizer(FIXTURE)
    want = jc.json_constraint(hf_fixture, jc.TOOLPROMPT_SCHEMA).fsm.dense_tables()
    got = pc.json_constraint(ours, pc.TOOLPROMPT_SCHEMA).fsm.dense_tables()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("family", ["qwen2.5-7b-instruct", "bench-8b"])
@pytest.mark.parametrize("tools", [None, [{"type": "function", "function": {
    "name": "kubectl", "parameters": {"type": "object",
                                      "properties": {"command": {"type": "string"}}}}}]])
def test_chat_template_ids_equal_jax(hf_fixture, family, tools):
    """ChatML for Qwen, the Llama-3 headers otherwise, as the JAX package
    renders them for a tokenizer with no chat template of its own."""
    messages = [{"role": "system", "content": "You are an ops agent."},
                {"role": "user", "content": "list the pods, 请"},
                {"role": "assistant", "content": None,
                 "tool_calls": [{"function": {"name": "kubectl", "arguments": "{}"}}]},
                {"role": "tool", "content": "pod-1 Running"}]
    got = apply_chat_template(BPETokenizer(FIXTURE), messages, family, tools)
    assert got == jax_template(hf_fixture, messages, family, tools)


def test_translate_pattern_builds_exact_classes():
    import re
    import unicodedata

    letters = re.compile(translate_pattern(r"\p{L}+"))
    numbers = re.compile(translate_pattern(r"^\p{N}$"))
    # DeepSeek's classes: punctuation, symbols, marks, alone and in a class.
    others = {k: re.compile(translate_pattern(rf"[x\p{{{k}}}]")) for k in "PSM"}
    for cp in list(range(0x3000)) + [0x4E2D, 0x1F600, 0x2160, 0x0663, 0xFF10, 0xFF5C,
                                     0x1F3FD, 0x20E3, 0xFE0F]:
        c = chr(cp)
        cat = unicodedata.category(c)
        assert bool(letters.fullmatch(c)) == cat.startswith("L"), hex(cp)
        assert bool(numbers.match(c)) == cat.startswith("N"), hex(cp)
        for k, regex in others.items():
            assert bool(regex.fullmatch(c)) == (cat.startswith(k) or c == "x"), (k, hex(cp))
    space = re.compile(translate_pattern(r"\s"))
    assert not space.match("\x1c") and space.match("　") and not space.match("​")
    for bad in (r"\p{Lu}", r"\P{L}", r"\w+", r"[\S]"):
        with pytest.raises(ValueError):
            translate_pattern(bad)


SP_FIXTURE = os.path.join(os.path.dirname(FIXTURE), "tiny-sp")
METASPACE = {"type": "Metaspace", "replacement": "\u2581", "prepend_scheme": "first",
             "split": False}
# (fixture, change): forms the reader takes, held to the tokenizers library.
VARIANTS = {
    "byte_fallback": (FIXTURE, {"model_extra": {"byte_fallback": True}}),
    "lstrip": (FIXTURE, {"added": {"lstrip": True}}),
    "rstrip": (FIXTURE, {"added": {"rstrip": True}}),
    "single_word": (FIXTURE, {"added": {"single_word": True}}),
    "normalized_added": (FIXTURE, {"added": {"normalized": True, "special": False}}),
    "add_prefix_space": (FIXTURE, {"pre_tokenizer": {
        "type": "ByteLevel", "add_prefix_space": True, "use_regex": True, "trim_offsets": True}}),
    "nfc_prefix_space_split": (FIXTURE, {"normalizer": {"type": "NFC"}, "pre_tokenizer": {
        "type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": True, "use_regex": False,
             "trim_offsets": False}]}}),
    **{f"metaspace_{scheme}_{'split' if split else 'whole'}": (SP_FIXTURE, {
        "normalizer": None,
        "pre_tokenizer": {**METASPACE, "prepend_scheme": scheme, "split": split},
        "decoder": {**METASPACE, "prepend_scheme": scheme, "split": split}})
       for scheme in ("first", "always", "never") for split in (False, True)},
    "sp_unk_fused": (SP_FIXTURE, {"model_extra": {"byte_fallback": False}}),
    "sp_unk_unfused": (SP_FIXTURE, {"model_extra": {"byte_fallback": False,
                                                    "fuse_unk": False}}),
}


def _variant(tmp_path, fixture: str, change: dict) -> str:
    """A copy of ``fixture`` with ``change`` made to its tokenizer.json."""
    with open(os.path.join(fixture, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    for key, value in change.items():
        if key == "model_extra":
            spec["model"].update(value)
        elif key == "added":
            spec["added_tokens"][-1].update(value)
        else:
            spec[key] = value
    with open(tmp_path / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(spec, f)
    return str(tmp_path)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tokenizer_json_variants_equal_tokenizers(tmp_path, variant):
    """Byte fallback, added tokens with lstrip / rstrip / single_word /
    normalized, ByteLevel's add_prefix_space, Metaspace at each prepend
    scheme with and without split, unk with and without fuse_unk: encode,
    decode and the token strings equal the tokenizers library's."""
    path = _variant(tmp_path, *VARIANTS[variant])
    hf, ours = Tokenizer.from_file(os.path.join(path, "tokenizer.json")), BPETokenizer(path)
    # The last added token (the one the added-token variants change) beside
    # spaces, word characters and itself.
    edges = ["a <|endoftext|>  b<|endoftext|>x _<|endoftext|> y\t<|endoftext|>",
             "<|endoftext|><|endoftext|>  <|endoftext|>", "\u2581 \u2581x"]
    for text in CORPUS + edges:
        want = hf.encode(text, add_special_tokens=False).ids
        assert ours.encode(text) == want, text
        assert ours.decode(want) == hf.decode(want, skip_special_tokens=True), text
    assert [ours.token_str(i) for i in range(ours.vocab_size)] == [
        hf.id_to_token(i) for i in range(ours.vocab_size)]


@pytest.mark.parametrize("change,name", [
    ({"pre_tokenizer": {"type": "Whitespace"}}, "Whitespace"),
    ({"normalizer": {"type": "Lowercase"}}, "Lowercase"),
    ({"decoder": {"type": "WordPiece"}}, "WordPiece"),
    ({"model": {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["a", -1.0]]}},
     "Unigram"),
    ({"model": {"type": "WordPiece", "unk_token": "[UNK]", "vocab": {"[UNK]": 0}}},
     "WordPiece"),
    ({"pre_tokenizer": {"type": "Digits", "individual_digits": True}}, "Digits"),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": " +"}, "content": " "}},
     "Replace"),
])
def test_unsupported_tokenizer_json_is_refused(tmp_path, change, name):
    """A component outside the reader's forms raises ValueError naming it."""
    path = _variant(tmp_path, FIXTURE, change)
    with pytest.raises(ValueError, match=name):
        BPETokenizer(path)


def test_a_sentencepiece_model_alone_is_refused(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\n\x00")
    with pytest.raises(ValueError, match="tokenizer.model"):
        BPETokenizer(str(tmp_path))


def test_load_tokenizer_and_engine_config(tmp_path):
    assert isinstance(load_tokenizer("", 512), ByteTokenizer)
    assert isinstance(load_tokenizer(FIXTURE), BPETokenizer)
    # No tokenizer_config.json: bos and eos 0, pad the eos.
    os.symlink(os.path.join(FIXTURE, "tokenizer.json"), tmp_path / "tokenizer.json")
    bare = BPETokenizer(str(tmp_path))
    assert (bare.bos_id, bare.eos_id, bare.pad_id) == (0, 0, 0)
    cfg = replace(TINY_TEST, vocab_size=1280)
    eng = Engine(EngineConfig(model="tiny-test", tokenizer=FIXTURE, dtype=torch.float32,
                              device="cpu", num_pages=32), model_cfg=cfg)
    assert isinstance(eng.tokenizer, BPETokenizer) and eng._extras.renderable == 1027


SCHEMA = {"type": "object", "properties": {"name": {"enum": ["kubectl", "trivy"]},
                                           "ok": {"type": "boolean"}}}
KW = dict(page_size=8, num_pages=256, max_pages_per_seq=32, max_batch_size=2)


def _bpe_engine(model, cfg, tok):
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               decode_block=8, **KW), model_cfg=cfg, model=model, tokenizer=tok)


def test_json_schema_tokens_through_bpe_equal_jax_engine(hf_fixture):
    """Greedy json_schema tokens of a tiny-test model over the fixture's
    1,027 ids through the port's engine, against the JAX engine with the
    fixture's ``HFTokenizer``, same weights; the prompt is ChatML, the
    FSM's token bytes the BPE's."""
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(64,), **KW),
                     model_cfg=replace(JAX_TINY, vocab_size=1027), tokenizer=hf_fixture)
    cfg = replace(TINY_TEST, vocab_size=1027)
    model = Llama(cfg, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params), cfg))
    tok = BPETokenizer(FIXTURE)
    eng = _bpe_engine(model, cfg, tok)
    messages = [{"role": "user", "content": "pick a tool"}]
    prompt = apply_chat_template(tok, messages, "qwen2.5-7b-instruct")
    assert prompt == jax_template(hf_fixture, messages, "qwen2.5-7b-instruct")
    sid = jeng.begin_request(prompt, JaxSamplingParams(max_tokens=48),
                             mask_fn=jc.json_constraint(hf_fixture, SCHEMA))
    while not jeng.prefill_step(sid):
        pass
    while not jeng.sequences[sid].done:
        jeng.step_block([sid])
    want = jeng.finish(sid)
    con = pc.json_constraint(tok, SCHEMA)
    assert con.fsm.token_bytes == [tok.token_bytes(i) for i in range(tok.vocab_size)]
    got = eng.generate([prompt], SamplingParams(max_tokens=48), mask_fn=[con])[0]
    assert got == want and got[-1] == tok.eos_id
    assert json.loads(tok.decode(got))["name"] in ("kubectl", "trivy")
    assert eng.fsm_loads == 1 and eng._fsm_loaded is con.fsm


def test_json_schema_through_bpe_over_a_padded_vocab():
    """A model vocab of 1,280 past the tokenizer's 1,027 (as Qwen2.5's
    152,064 is past its tokenizer's): the constrained row never emits an id
    the tokenizer lacks, and its reply parses; logprobs' top ids stay
    inside the tokenizer's vocab too."""
    cfg = replace(TINY_TEST, vocab_size=1280)
    tok = BPETokenizer(FIXTURE)
    eng = _bpe_engine(Llama(cfg, torch.float32, "cpu", seed=3), cfg, tok)
    prompt = apply_chat_template(tok, [{"role": "user", "content": "pick"}], "qwen2.5")
    con = pc.json_constraint(tok, SCHEMA)
    sid = eng.add_request(prompt, SamplingParams(max_tokens=48, logprobs=True,
                                                 top_logprobs=20), con)
    while not eng.sequences[sid].done:
        eng.step_block([sid])
    data = eng.sequences[sid].logprob_data
    got = eng.finish(sid)
    assert max(got) < tok.vocab_size and got[-1] == tok.eos_id
    assert json.loads(tok.decode(got))["name"] in ("kubectl", "trivy")
    assert len(data) == len(got)
    assert all(i < tok.vocab_size for d in data for i, _ in d["top"])
