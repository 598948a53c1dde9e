"""Tokenizers for the port's serving engine (the counterpart of
``opsagent_tpu/serving/tokenizer.py``).

Two implementations behind one interface:

- ``ByteTokenizer``: UTF-8 bytes plus special tokens, deterministic, with
  no downloaded artifacts (tests and random-weight serving);
- ``BPETokenizer``: a BPE read from a HuggingFace ``tokenizer.json`` with
  ``json`` alone, in the forms the supported families ship: byte-level
  (Llama-3, Qwen2, DeepSeek, GPT-2) and SentencePiece-style with byte
  fallback (Mistral, Llama-2). It is the counterpart of the JAX package's
  ``HFTokenizer``, which wraps ``transformers``, and carries the
  directory's chat template and the special-token strings a template
  reads. It needs neither ``tokenizers`` nor ``transformers`` nor
  ``regex``: the pre-tokenizers' ``\\p{..}`` classes are built from
  ``unicodedata`` into ``re`` classes.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import sys
import unicodedata
from typing import Any, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...
    def token_str(self, token_id: int) -> str: ...
    def token_bytes(self, token_id: int) -> bytes: ...


class ByteTokenizer:
    """UTF-8 bytes + specials. ids 0..255 = bytes; 256=PAD, 257=BOS, 258=EOS,
    259..262 = chat-structure markers."""

    PAD, BOS, EOS = 256, 257, 258
    SYS, USER, ASSISTANT, END = 259, 260, 261, 262

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 263:
            raise ValueError(f"vocab_size {vocab_size} < 263 byte-tokenizer ids")
        self.vocab_size = vocab_size
        self.pad_id = self.PAD
        self.bos_id = self.BOS
        self.eos_id = self.EOS

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def token_str(self, token_id: int) -> str:
        """The token as text for logprobs: its character for an ASCII byte,
        "" otherwise (half of a multi-byte character, or a special)."""
        if 0 <= token_id < 128:
            return chr(token_id)
        return ""

    def token_bytes(self, token_id: int) -> bytes:
        """The bytes this token adds to the output: one byte for ids
        0..255, none for a special or padded id (constrained decoding
        forbids those)."""
        if 0 <= token_id < 256:
            return bytes([token_id])
        return b""


# -- BPE from tokenizer.json ----------------------------------------------------
# The pre-tokenizer of a bare ``ByteLevel`` with ``use_regex`` (GPT-2's).
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
# Unicode White_Space, the ``\s`` of the tokenizers library's regex engine
# (Python's ``\s`` also takes U+001C-U+001F).
_WHITE_SPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
)
# General categories a ``\p{..}`` may name: letters, marks, numbers,
# punctuation, symbols.
_CATEGORIES = ("L", "M", "N", "P", "S")


def _escape_class_char(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.cache
def _category_class(prefix: str) -> str:
    """The contents of an ``re`` character class (no brackets) holding
    every code point whose general category starts with ``prefix`` ("L":
    letters, "M": marks, "N": numbers, "P": punctuation, "S": symbols),
    as ranges."""
    ranges: list[tuple[int, int]] = []
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if ranges and ranges[-1][1] == cp - 1:
                ranges[-1] = (ranges[-1][0], cp)
            else:
                ranges.append((cp, cp))
    return "".join(
        _escape_class_char(a) if a == b else f"{_escape_class_char(a)}-{_escape_class_char(b)}"
        for a, b in ranges
    )


def translate_pattern(pattern: str) -> str:
    """A pre-tokenizer pattern of the tokenizers library as a Python ``re``
    pattern with the same matches: ``\\p{L}``, ``\\p{M}``, ``\\p{N}``,
    ``\\p{P}`` and ``\\p{S}`` become the exact classes of their categories,
    ``\\s`` and ``\\S`` Unicode White_Space and its complement; everything
    else (``(?i:...)``, lookaheads, counted repeats, escaped punctuation)
    is ``re`` syntax already. Raises ValueError for a construct it cannot
    carry over exactly."""
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP":
                m = re.match(r"\\([pP])\{(\w+)\}", pattern[i:])
                if not m or m.group(1) == "P" or m.group(2) not in _CATEGORIES:
                    raise ValueError(f"unsupported class {pattern[i:i + 8]!r} in {pattern!r}")
                body = _category_class(m.group(2))
                out.append(body if in_class else f"[{body}]")
                i += len(m.group(0))
                continue
            if nxt == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif nxt == "S":
                if in_class:
                    raise ValueError(f"\\S inside a class in {pattern!r}")
                out.append(f"[^{_WHITE_SPACE}]")
            elif nxt in "wWdDbB":
                raise ValueError(f"unsupported escape \\{nxt} in {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


@functools.cache
def _byte_encoder() -> dict[int, str]:
    """GPT-2's byte -> printable character map of byte-level BPE."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.cache
def _byte_decoder() -> dict[str, int]:
    return {c: b for b, c in _byte_encoder().items()}


def _byte_level_bytes(s: str) -> bytes:
    """The ByteLevel decoder's bytes of one token string: its characters
    through the byte map, or its UTF-8 when one of them is outside the
    map."""
    dec = _byte_decoder()
    if all(c in dec for c in s):
        return bytes(dec[c] for c in s)
    return s.encode("utf-8")


_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _token_name(value: Any) -> str | None:
    """A special token of ``tokenizer_config.json``: a string, or an
    ``AddedToken`` object with its ``content``."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _isolate(regex: re.Pattern, text: str) -> list[str]:
    """``Split`` with the ``Isolated`` behavior: the matches and the gaps
    between them, in order (empty matches cut nothing)."""
    out: list[str] = []
    pos = 0
    for m in regex.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > pos:
            out.append(text[pos:m.start()])
        out.append(m.group(0))
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


# A piece of text on its way to the model: (text, starts at offset 0 of the
# input). Metaspace's prepend scheme "first" reads the flag.
Piece = tuple[str, bool]


def _normalizer_steps(spec: dict[str, Any] | None) -> list:
    """The ``normalizer`` of tokenizer.json as functions over a string:
    none, NFC, ``Prepend``, ``Replace`` of a string, or a ``Sequence`` of
    them."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec.get("normalizers") or [] for step in _normalizer_steps(sub)]
    if kind == "NFC":
        return [functools.partial(unicodedata.normalize, "NFC")]
    if kind == "Prepend":
        prefix = spec["prepend"]
        return [lambda t: prefix + t if t else t]
    if kind == "Replace" and "String" in (spec.get("pattern") or {}):
        old, new = spec["pattern"]["String"], spec["content"]
        return [lambda t: t.replace(old, new)]
    raise ValueError(f"normalizer {kind!r} ({spec}) is not supported")


def _metaspace(spec: dict[str, Any]):
    """The ``Metaspace`` pre-tokenizer: spaces become the replacement, which
    is prepended by its scheme (``always``; ``first``: to the piece at
    offset 0 only; ``never``), and with ``split`` each replacement starts
    a piece."""
    rep = spec.get("replacement", "\u2581")
    scheme = spec.get("prepend_scheme")
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"Metaspace prepend_scheme {scheme!r} is not supported")
    split = spec.get("split", True)

    def step(pieces: list[Piece]) -> list[Piece]:
        out: list[Piece] = []
        for text, first in pieces:
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                text = rep + text
            if not split:
                out.append((text, first))
                continue
            cuts = [i for i, c in enumerate(text) if c == rep and i > 0]
            for j, (a, b) in enumerate(zip([0, *cuts], [*cuts, len(text)])):
                out.append((text[a:b], first and j == 0))
        return out

    return step


def _pre_tokenizer_steps(spec: dict[str, Any] | None) -> tuple[list, bool]:
    """(steps over lists of pieces, whether the pieces end byte-level) of
    the ``pre_tokenizer``: none; ``Metaspace``; ``ByteLevel``
    (``add_prefix_space``; ``use_regex``: GPT-2's pattern); or a
    ``Sequence`` of ``Split`` (a regex, ``Isolated``) and ``Metaspace``
    steps, with at most one ``ByteLevel`` and that one last."""
    if spec is None:
        return [], False
    parts = spec.get("pretokenizers") or [] if spec.get("type") == "Sequence" else [spec]
    steps, byte_level = [], False
    for part in parts:
        kind = part.get("type")
        if byte_level:
            raise ValueError(f"pre-tokenizer {kind!r} after ByteLevel is not supported")
        if kind == "Split":
            if (part.get("behavior") != "Isolated" or part.get("invert")
                    or "Regex" not in (part.get("pattern") or {})):
                raise ValueError(f"pre-tokenizer Split {part} is not supported")
            regex = re.compile(translate_pattern(part["pattern"]["Regex"]))
            steps.append(lambda ps, r=regex: [
                (t, f and j == 0) for text, f in ps for j, t in enumerate(_isolate(r, text))])
        elif kind == "Metaspace":
            steps.append(_metaspace(part))
        elif kind == "ByteLevel":
            byte_level = True
            prefix = bool(part.get("add_prefix_space"))
            regex = re.compile(translate_pattern(GPT2_PATTERN)) if part.get(
                "use_regex", True) else None

            def step(ps, prefix=prefix, regex=regex):
                out = []
                for text, f in ps:
                    if prefix and not text.startswith(" "):
                        text = " " + text
                    pieces = _isolate(regex, text) if regex is not None else [text]
                    out += [(t, f and j == 0) for j, t in enumerate(pieces)]
                return out

            steps.append(step)
        else:
            raise ValueError(f"pre-tokenizer {kind!r} ({part}) is not supported")
    return steps, byte_level


def _decoder_steps(spec: dict[str, Any] | None) -> list:
    """The ``decoder`` as functions over the list of token strings:
    ``ByteLevel``, ``Metaspace``, or a ``Sequence`` of ``Replace`` (of a
    string), ``ByteFallback``, ``Fuse``, ``Strip`` and those two, each as
    the tokenizers library applies it."""
    kind = (spec or {}).get("type")
    if kind == "Sequence":
        return [step for sub in spec.get("decoders") or [] for step in _decoder_steps(sub)]
    if kind == "ByteLevel":
        return [lambda toks: [
            b"".join(_byte_level_bytes(t) for t in toks).decode("utf-8", errors="replace")]]
    if kind == "Metaspace":
        rep = spec.get("replacement", "\u2581")
        scheme = spec.get("prepend_scheme")
        # The first token loses every replacement character, the others
        # turn them into spaces (the library's rule).
        return [lambda toks: [
            t.replace(rep, "" if i == 0 and scheme != "never" else " ")
            for i, t in enumerate(toks)]]
    if kind == "Replace" and "String" in (spec.get("pattern") or {}):
        old, new = spec["pattern"]["String"], spec["content"]
        return [lambda toks: [t.replace(old, new) for t in toks]]
    if kind == "ByteFallback":
        return [_byte_fallback]
    if kind == "Fuse":
        return [lambda toks: ["".join(toks)]]
    if kind == "Strip":
        content, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])

        def strip(toks):
            out = []
            for t in toks:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                while len(t) - b < stop and b > a and t[b - 1] == content:
                    b -= 1
                out.append(t[a:b])
            return out

        return [strip]
    raise ValueError(f"decoder {kind!r} ({spec}) is not supported")


def _byte_fallback(toks: list[str]) -> list[str]:
    """Runs of ``<0xNN>`` tokens become the text of their bytes, or one
    U+FFFD per byte when the run is not UTF-8."""
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()

    for t in toks:
        m = _BYTE_TOKEN.fullmatch(t)
        if m:
            run.append(int(m.group(1), 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


# Pieces whose BPE result is kept (the tokenizers library keeps 10,000).
_BPE_CACHE_SIZE = 100_000
# transformers' clean_up_tokenization, applied by decode when the config
# sets clean_up_tokenization_spaces.
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
# The special-token attributes a chat template sees, as transformers names
# them (its ``special_tokens_map``: those set in the config).
TEMPLATE_SPECIALS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                     "cls_token", "mask_token", "additional_special_tokens")


class BPETokenizer:
    """A BPE tokenizer from the HuggingFace ``tokenizer.json`` in the
    directory ``path``, with ``bos``, ``eos``, ``pad`` and the chat
    template from a ``tokenizer_config.json`` beside it (and a
    ``chat_template.jinja``, or ``additional_chat_templates/*.jinja``, which
    take priority), as the JAX package's ``HFTokenizer`` takes them through
    ``transformers`` (missing: bos and eos 0, pad the eos). Reads:

    - ``model``: a BPE ``vocab`` and ``merges`` (``"a b"`` or ``[a, b]``),
      applied by merge rank, lowest first, leftmost among equal ranks;
      ``ignore_merges`` (a piece that is one token is taken whole);
      ``byte_fallback`` (a character with no token becomes its UTF-8
      bytes' ``<0xNN>`` tokens), ``unk_token`` and ``fuse_unk``;
    - ``added_tokens``: split out of the text first (the longest at each
      position), the ``normalized`` ones out of the normalized text; with
      ``lstrip`` / ``rstrip`` a token takes the whitespace beside it, with
      ``single_word`` it matches only between non-word characters;
      ``decode`` skips the special ones;
    - ``normalizer``: none, NFC, ``Prepend``, ``Replace`` of a string, or a
      ``Sequence`` of them (Mistral's and Llama-2's ``Prepend("▁")`` and
      ``Replace(" ", "▁")``);
    - ``pre_tokenizer``: none; ``Metaspace``; a bare ``ByteLevel`` (GPT-2's
      pattern with ``use_regex``, ``add_prefix_space``); or a ``Sequence``
      of ``Split(Regex, Isolated)`` steps before ``ByteLevel(use_regex=
      false)`` (Llama-3 and Qwen2 one, DeepSeek three);
    - ``decoder``: ``ByteLevel``, ``Metaspace``, or a ``Sequence`` of
      ``Replace``, ``ByteFallback``, ``Fuse`` and ``Strip``.

    Anything else raises ValueError naming it (a Unigram or WordPiece
    model, another normalizer, pre-tokenizer or decoder; a directory with
    only ``tokenizer.model``): a tokenizer this reader would split
    differently is refused, never approximated."""

    def __init__(self, path: str):
        file = os.path.join(path, "tokenizer.json")
        if not os.path.exists(file):
            raise ValueError(f"{path}: no tokenizer.json (a SentencePiece "
                             "tokenizer.model alone is not supported)")
        with open(file, encoding="utf-8") as f:
            spec = json.load(f)
        config_file = os.path.join(path, "tokenizer_config.json")
        config: dict[str, Any] = {}
        if os.path.exists(config_file):
            with open(config_file, encoding="utf-8") as f:
                config = json.load(f)
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"{file}: model type {model.get('type')!r}, expected BPE")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise ValueError(f"{file}: BPE {key}={model[key]!r} is not supported")
        self._vocab: dict[str, int] = dict(model["vocab"])
        self._ignore_merges = bool(model.get("ignore_merges"))
        self._byte_fallback = bool(model.get("byte_fallback"))
        self._unk = model.get("unk_token")
        self._fuse_unk = bool(model.get("fuse_unk"))
        # (a, b) -> rank; a pair listed twice keeps its last rank, as the
        # library's merge map does.
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(model.get("merges") or []):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self._ranks[(a, b)] = rank
        self._id_str = {i: s for s, i in self._vocab.items()}
        self._normalize = _normalizer_steps(spec.get("normalizer"))
        self._pre, self._byte_level = _pre_tokenizer_steps(spec.get("pre_tokenizer"))
        self._decoder = _decoder_steps(spec.get("decoder"))

        self._added: dict[str, dict[str, Any]] = {}
        self._skipped: set[int] = set()   # decode skips these: the special tokens
        for tok in spec.get("added_tokens") or []:
            self._added[tok["content"]] = tok
            self._id_str[tok["id"]] = tok["content"]
            if tok.get("special"):
                self._skipped.add(tok["id"])
        raw = [t for t in self._added.values() if not t.get("normalized")]
        self._raw_re = self._added_regex({t["content"]: t for t in raw})
        # A normalized token is matched by its normalized content.
        self._norm_re = self._added_regex({
            self._normalized(t["content"]): t for t in self._added.values()
            if t.get("normalized")})
        self.vocab_size = max(self._id_str) + 1

        def config_id(key: str) -> int | None:
            name = _token_name(config.get(key))
            return None if name is None else self._token_id(name)

        self.bos_id = config_id("bos_token") or 0
        self.eos_id = config_id("eos_token") or 0
        pad = config_id("pad_token")
        self.pad_id = pad if pad is not None else self.eos_id
        # The config's named specials: transformers' all_special_ids, to
        # which token_bytes gives b"" (and which decode skips too).
        self.template_specials: dict[str, Any] = {}
        for key in TEMPLATE_SPECIALS:
            value = config.get(key)
            value = ([_token_name(v) for v in value] if isinstance(value, list)
                     else _token_name(value))
            if value:
                self.template_specials[key] = value
        named = [v for k, v in self.template_specials.items() if k != "additional_special_tokens"]
        named += self.template_specials.get("additional_special_tokens", [])
        self._special = {tid for tid in map(self._token_id, named) if tid is not None}
        self._skipped |= self._special
        self._clean_up = bool(config.get("clean_up_tokenization_spaces"))
        self.chat_template = _chat_template(path, config)
        self._cache: dict[str, list[int]] = {}

    @staticmethod
    def _added_regex(tokens: dict[str, dict[str, Any]]):
        """(regex of the contents, longest first, content -> token), or
        None: the leftmost match, and the longest there, wins."""
        if not tokens:
            return None
        alt = "|".join(re.escape(s) for s in sorted(tokens, key=len, reverse=True) if s)
        return (re.compile(alt), tokens) if alt else None

    def _token_id(self, name: str | None) -> int | None:
        if name is None:
            return None
        tok = self._added.get(name)
        return tok["id"] if tok is not None else self._vocab.get(name)

    def _normalized(self, text: str) -> str:
        for step in self._normalize:
            text = step(text)
        return text

    # -- encode -------------------------------------------------------------------
    @staticmethod
    def _split_added(text: str, matcher) -> list[tuple[str, int | None, int]]:
        """The text cut at its added tokens, as the library's added
        vocabulary cuts it: (text, None, offset) for the pieces between
        tokens, (matched text, id, offset) for each token, which takes the
        whitespace beside it with ``lstrip`` / ``rstrip`` and matches only
        between non-word characters with ``single_word``."""
        if matcher is None or not text:
            return [(text, None, 0)]
        regex, tokens = matcher
        out: list[tuple[str, int | None, int]] = []
        done = 0
        for m in regex.finditer(text):
            a, b = m.span()
            tok = tokens[m.group(0)]
            if tok.get("single_word") and (
                    (a > 0 and _is_word_char(text[a - 1]))
                    or (b < len(text) and _is_word_char(text[b]))):
                continue
            if tok.get("lstrip"):
                a = max(len(text[:a].rstrip(_WS)), done)
            if tok.get("rstrip"):
                b = len(text) - len(text[b:].lstrip(_WS))
            if a > done:
                out.append((text[done:a], None, done))
            out.append((text[a:b], tok["id"], a))
            done = b
        if done < len(text):
            out.append((text[done:], None, done))
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids of ``text``, no special tokens added: added tokens cut
        out, each piece between them normalized, then cut at the
        normalized added tokens, pre-tokenized and BPE'd."""
        ids: list[int] = []
        for piece, tid, at in self._split_added(text, self._raw_re):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self._normalized(piece)
            for sub, tid2, at2 in self._split_added(norm, self._norm_re):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                pieces: list[Piece] = [(sub, at == 0 and at2 == 0)] if sub else []
                for step in self._pre:
                    pieces = step(pieces)
                for p, _ in pieces:
                    if p:
                        ids.extend(self._bpe(p))
        return ids

    def _bpe(self, piece: str) -> list[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        if self._byte_level:
            enc = _byte_encoder()
            word = "".join(enc[b] for b in piece.encode("utf-8"))
        else:
            word = piece
        if self._ignore_merges and word in self._vocab:
            out = [self._vocab[word]]
        else:
            out = [self._vocab[s] for s in self._merge(self._symbols(word))]
        if len(self._cache) >= _BPE_CACHE_SIZE:
            self._cache.clear()
        self._cache[piece] = out
        return out

    def _symbols(self, word: str) -> list[str]:
        """The word's characters as tokens: a character in the vocab as
        itself; otherwise, with byte fallback, its UTF-8 bytes' ``<0xNN>``
        tokens when all exist; otherwise the unk token (one for a run of
        them with ``fuse_unk``), or nothing when there is none."""
        syms: list[str] = []
        unk_pending = False
        for c in word:
            if c in self._vocab:
                if unk_pending:
                    syms.append(self._unk)
                    unk_pending = False
                syms.append(c)
                continue
            if self._byte_fallback:
                codes = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(code in self._vocab for code in codes):
                    syms.extend(codes)
                    continue
            if self._unk is not None:
                if unk_pending and not self._fuse_unk:
                    syms.append(self._unk)
                unk_pending = True
        if unk_pending:
            syms.append(self._unk)
        return syms

    def _merge(self, syms: list[str]) -> list[str]:
        """BPE merges over a linked list of symbols, lowest rank first and
        leftmost among equal ranks, through a heap of candidate pairs whose
        stale entries are skipped (the library's ``merge_all``)."""
        n = len(syms)
        if n < 2:
            return syms
        ranks = self._ranks
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(r, i) for i in range(n - 1)
                if (r := ranks.get((syms[i], syms[i + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            rank, i = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j < 0 or ranks.get((syms[i], syms[j])) != rank:
                continue
            syms[i] += syms[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            p, k = prev[i], nxt[i]
            if p >= 0 and (r := ranks.get((syms[p], syms[i]))) is not None:
                heapq.heappush(heap, (r, p))
            if k >= 0 and (r := ranks.get((syms[i], syms[k]))) is not None:
                heapq.heappush(heap, (r, i))
        return [s for s, live in zip(syms, alive) if live]

    # -- decode -------------------------------------------------------------------
    def decode(self, ids: list[int]) -> str:
        """Text of ``ids``, special tokens skipped: the token strings
        through the decoder."""
        toks = [self._id_str[i] for i in ids if i in self._id_str and i not in self._skipped]
        for step in self._decoder:
            toks = step(toks)
        text = "".join(toks)
        if self._clean_up:
            for old, new in _CLEAN_UP:
                text = text.replace(old, new)
        return text

    def token_str(self, token_id: int) -> str:
        """The vocabulary's string of the token."""
        return self._id_str.get(token_id, "")

    def token_bytes(self, token_id: int) -> bytes:
        """The bytes one token adds to the output, by the JAX package's
        rule (``HFTokenizer.token_bytes``): b"" for a special token (one
        the config names) or an id outside the vocab; a token whose every
        character is in the GPT-2 byte map through that map; otherwise
        its text with ``▁`` as a space, in UTF-8. On a SentencePiece vocab
        the map takes ``é`` to the byte 0xE9, and ``<0x0A>`` (six ASCII
        characters, all in the map) to those six characters: JAX's rule
        tests the map before the ``<0xNN>`` form, which it never reaches."""
        s = self._id_str.get(token_id)
        if s is None or token_id in self._special:
            return b""
        dec = _byte_decoder()
        if all(c in dec for c in s):
            return bytes(dec[c] for c in s)
        return s.replace("\u2581", " ").encode("utf-8")


# Unicode White_Space as characters: what lstrip / rstrip of an added token
# take (the library's char::is_whitespace).
_WS = ("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
       + "\u2028\u2029\u202f\u205f\u3000")


def _chat_template(path: str, config: dict[str, Any]) -> str | dict[str, str] | None:
    """The directory's chat template where transformers finds it: a
    ``chat_template.jinja`` ("default") and ``additional_chat_templates/
    *.jinja`` (by name) take priority over ``tokenizer_config.json``'s
    ``chat_template``, a string or a list of named templates. A dict of
    several is resolved when rendered."""
    templates: dict[str, str] = {}
    main = os.path.join(path, "chat_template.jinja")
    if os.path.exists(main):
        with open(main, encoding="utf-8") as f:
            templates["default"] = f.read()
    extra = os.path.join(path, "additional_chat_templates")
    if os.path.isdir(extra):
        for name in sorted(os.listdir(extra)):
            if name.endswith(".jinja"):
                with open(os.path.join(extra, name), encoding="utf-8") as f:
                    templates[name[:-len(".jinja")]] = f.read()
    if templates:
        return templates["default"] if list(templates) == ["default"] else templates
    value = config.get("chat_template")
    if isinstance(value, list):
        return {t["name"]: t["template"] for t in value}
    return value or None


def load_tokenizer(path: str = "", vocab_size: int = 512) -> Tokenizer:
    """``BPETokenizer`` of the tokenizer directory ``path``; the byte
    tokenizer over ``vocab_size`` ids without one."""
    if path:
        return BPETokenizer(path)
    return ByteTokenizer(vocab_size=vocab_size)
