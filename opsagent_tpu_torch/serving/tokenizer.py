"""Tokenizers for the port's serving engine (the counterpart of
``opsagent_tpu/serving/tokenizer.py``).

Only the hermetic ``ByteTokenizer`` is ported: UTF-8 bytes plus special
tokens, deterministic, with no downloaded artifacts. The HuggingFace
tokenizer waits until ``transformers`` is available beside the GPU.
"""

from __future__ import annotations

from typing import Protocol


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...
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

    def token_bytes(self, token_id: int) -> bytes:
        """The bytes this token adds to the output: one byte for ids
        0..255, none for a special or padded id (constrained decoding
        forbids those)."""
        if 0 <= token_id < 256:
            return bytes([token_id])
        return b""
