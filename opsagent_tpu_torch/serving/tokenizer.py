"""Tokenizers for the port's serving engine (the counterpart of
``opsagent_tpu/serving/tokenizer.py``).

Two implementations behind one interface:

- ``ByteTokenizer``: UTF-8 bytes plus special tokens, deterministic, with
  no downloaded artifacts (tests and random-weight serving);
- ``BPETokenizer``: a byte-level BPE read from a HuggingFace
  ``tokenizer.json`` with ``json`` alone (Llama-3, Qwen2 and GPT-2 style
  vocabularies), the counterpart of the JAX package's ``HFTokenizer``,
  which wraps ``transformers``. It needs neither ``tokenizers`` nor
  ``transformers`` nor ``regex``: the pre-tokenizer's ``\\p{L}`` and
  ``\\p{N}`` classes are built from ``unicodedata`` into ``re`` classes.
"""

from __future__ import annotations

import functools
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


# -- byte-level BPE --------------------------------------------------------------
# The pre-tokenizer of a bare ``ByteLevel`` with ``use_regex`` (GPT-2's).
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
# Unicode White_Space, the ``\s`` of the tokenizers library's regex engine
# (Python's ``\s`` also takes U+001C-U+001F).
_WHITE_SPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
)


def _escape_class_char(cp: int) -> str:
    return f"\\U{cp:08x}"


@functools.cache
def _category_class(prefix: str) -> str:
    """The contents of an ``re`` character class (no brackets) holding
    every code point whose general category starts with ``prefix`` ("L":
    letters, "N": numbers), as ranges."""
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
    pattern with the same matches: ``\\p{L}`` and ``\\p{N}`` become the
    exact classes of their categories, ``\\s`` and ``\\S`` Unicode
    White_Space and its complement; everything else (``(?i:...)``,
    lookaheads, counted repeats) is ``re`` syntax already. Raises
    ValueError for a construct it cannot carry over exactly."""
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP":
                m = re.match(r"\\([pP])\{(\w+)\}", pattern[i:])
                if not m or m.group(1) == "P" or m.group(2) not in ("L", "N"):
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


def _token_name(value: Any) -> str | None:
    """A special token of ``tokenizer_config.json``: a string, or an
    ``AddedToken`` object with its ``content``."""
    if isinstance(value, dict):
        return value.get("content")
    return value


# Pieces whose BPE result is kept (the tokenizers library keeps 10,000).
_BPE_CACHE_SIZE = 100_000


class BPETokenizer:
    """A byte-level BPE tokenizer from the HuggingFace ``tokenizer.json`` in
    the directory ``path``, with ``bos``, ``eos`` and
    ``pad`` from a ``tokenizer_config.json`` beside it, as the JAX
    package's ``HFTokenizer`` takes them (missing: bos and eos 0, pad the
    eos). Reads:

    - ``model``: a BPE ``vocab`` and ``merges`` (``"a b"`` or ``[a, b]``),
      applied by merge rank, lowest first, leftmost among equal ranks;
      ``ignore_merges`` (a piece that is one token is taken whole);
    - ``added_tokens``: split out of the text before anything else (the
      longest at each position); ``decode`` skips the special ones and
      ``token_bytes`` gives b"" for them;
    - ``normalizer``: none, or NFC;
    - ``pre_tokenizer``: a bare ``ByteLevel`` (GPT-2's pattern with
      ``use_regex``), or ``Sequence[Split(Regex), ByteLevel(use_regex=
      false)]``, the Llama-3 and Qwen2 form;
    - ``decoder``: ``ByteLevel``.

    Anything else raises ValueError naming it: a tokenizer this reader
    would split differently is refused, never approximated."""

    def __init__(self, path: str):
        file = os.path.join(path, "tokenizer.json")
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
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                    "byte_fallback"):
            if model.get(key):
                raise ValueError(f"{file}: BPE {key}={model[key]!r} is not supported")
        self._vocab: dict[str, int] = dict(model["vocab"])
        self._ignore_merges = bool(model.get("ignore_merges"))
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(model.get("merges") or []):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self._ranks.setdefault((a, b), rank)
        self._id_str = {i: s for s, i in self._vocab.items()}
        added: dict[str, int] = {}
        self._special: set[int] = set()
        for tok in spec.get("added_tokens") or []:
            for key in ("single_word", "lstrip", "rstrip"):
                if tok.get(key):
                    raise ValueError(
                        f"{file}: added token {tok['content']!r} with {key} is not supported"
                    )
            added[tok["content"]] = tok["id"]
            self._id_str[tok["id"]] = tok["content"]
            if tok.get("special"):
                self._special.add(tok["id"])
        # Longest first: at each position the longest added token wins.
        self._added = added
        self._added_re = re.compile(
            "|".join(re.escape(s) for s in sorted(added, key=len, reverse=True))
        ) if added else None
        normalizer = spec.get("normalizer")
        if normalizer is not None and normalizer.get("type") != "NFC":
            raise ValueError(f"{file}: normalizer {normalizer.get('type')!r} is not supported")
        self._nfc = normalizer is not None
        self._split = re.compile(translate_pattern(self._split_pattern(spec.get("pre_tokenizer"))))
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise ValueError(f"{file}: decoder {decoder.get('type')!r}, expected ByteLevel")
        self.vocab_size = max(self._id_str) + 1

        def config_id(key: str) -> int | None:
            name = _token_name(config.get(key))
            return None if name is None else self._token_id(name)

        self.bos_id = config_id("bos_token") or 0
        self.eos_id = config_id("eos_token") or 0
        pad = config_id("pad_token")
        self.pad_id = pad if pad is not None else self.eos_id
        # The config's named specials count as special too (they are what
        # the JAX package's tokenizer skips).
        named = [config.get(k) for k in ("bos_token", "eos_token", "pad_token", "unk_token")]
        named += config.get("additional_special_tokens") or []
        for value in named:
            tid = self._token_id(_token_name(value)) if value is not None else None
            if tid is not None:
                self._special.add(tid)
        self._cache: dict[str, list[int]] = {}

    def _token_id(self, name: str | None) -> int | None:
        if name is None:
            return None
        return self._added.get(name, self._vocab.get(name))

    @staticmethod
    def _split_pattern(pre: dict[str, Any] | None) -> str:
        """The regex that cuts text into pieces, from the pre-tokenizer."""

        def byte_level(p: dict[str, Any], regex: bool) -> None:
            if p.get("add_prefix_space"):
                raise ValueError("ByteLevel add_prefix_space is not supported")
            if bool(p.get("use_regex", True)) != regex:
                raise ValueError(f"ByteLevel use_regex={p.get('use_regex', True)} here "
                                 "is not supported")

        kind = (pre or {}).get("type")
        if kind == "ByteLevel":
            byte_level(pre, True)
            return GPT2_PATTERN
        if kind == "Sequence":
            parts = pre.get("pretokenizers") or []
            if (len(parts) == 2 and parts[0].get("type") == "Split"
                    and parts[1].get("type") == "ByteLevel"):
                split = parts[0]
                if (split.get("behavior") != "Isolated" or split.get("invert")
                        or "Regex" not in (split.get("pattern") or {})):
                    raise ValueError(f"pre-tokenizer Split {split} is not supported")
                byte_level(parts[1], False)
                return split["pattern"]["Regex"]
        raise ValueError(f"pre-tokenizer {pre!r} is not supported")

    # -- encode -------------------------------------------------------------------
    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        matches = self._added_re.finditer(text) if self._added_re is not None else ()
        for m in matches:
            self._encode_plain(text[pos:m.start()], ids)
            ids.append(self._added[m.group(0)])
            pos = m.end()
        self._encode_plain(text[pos:], ids)
        return ids

    def _encode_plain(self, text: str, ids: list[int]) -> None:
        """Text with no added token in it: normalize, cut into pieces (the
        pattern's matches and the gaps between them), BPE each piece."""
        if not text:
            return
        if self._nfc:
            text = unicodedata.normalize("NFC", text)
        pos = 0
        for m in self._split.finditer(text):
            if m.start() > pos:
                ids.extend(self._bpe(text[pos:m.start()]))
            ids.extend(self._bpe(m.group(0)))
            pos = m.end()
        if pos < len(text):
            ids.extend(self._bpe(text[pos:]))

    def _bpe(self, piece: str) -> list[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        enc = _byte_encoder()
        word = "".join(enc[b] for b in piece.encode("utf-8"))
        if self._ignore_merges and word in self._vocab:
            out = [self._vocab[word]]
        else:
            # Characters outside the vocab are dropped (no unk token).
            syms = [c for c in word if c in self._vocab]
            while len(syms) > 1:
                best, at = None, -1
                for i in range(len(syms) - 1):
                    rank = self._ranks.get((syms[i], syms[i + 1]))
                    if rank is not None and (best is None or rank < best):
                        best, at = rank, i
                if best is None:
                    break
                syms[at:at + 2] = [syms[at] + syms[at + 1]]
            out = [self._vocab[s] for s in syms]
        if len(self._cache) >= _BPE_CACHE_SIZE:
            self._cache.clear()
        self._cache[piece] = out
        return out

    # -- decode -------------------------------------------------------------------
    @staticmethod
    def _string_bytes(s: str) -> bytes:
        """The ByteLevel decoder's bytes of one token string: its
        characters through the byte map, or its UTF-8 when one of them is
        outside the map."""
        dec = _byte_decoder()
        if all(c in dec for c in s):
            return bytes(dec[c] for c in s)
        return s.encode("utf-8")

    def decode(self, ids: list[int]) -> str:
        """Text of ``ids``, special tokens skipped."""
        out = bytearray()
        for i in ids:
            s = self._id_str.get(i)
            if s is not None and i not in self._special:
                out += self._string_bytes(s)
        return out.decode("utf-8", errors="replace")

    def token_str(self, token_id: int) -> str:
        """The vocabulary's string of the token (byte-level characters)."""
        return self._id_str.get(token_id, "")

    def token_bytes(self, token_id: int) -> bytes:
        """Raw bytes of one token, undoing byte-level BPE's printable-char
        remapping; b"" for a special token and an id outside the vocab
        (constrained decoding forbids those)."""
        s = self._id_str.get(token_id)
        if s is None or token_id in self._special:
            return b""
        return self._string_bytes(s)


def load_tokenizer(path: str = "", vocab_size: int = 512) -> Tokenizer:
    """``BPETokenizer`` of the tokenizer directory ``path``; the byte
    tokenizer over ``vocab_size`` ids without one."""
    if path:
        return BPETokenizer(path)
    return ByteTokenizer(vocab_size=vocab_size)
