"""Regenerate this directory's byte-level-BPE tokenizer: ``tokenizer.json``
and ``tokenizer_config.json``.

    JAX_PLATFORMS=cpu python tests/fixtures/tiny-bpe/make_tokenizer.py

Trains with ``scripts/train_tiny_agent.py``'s ``train_bpe_tokenizer`` (the
agent corpus plus the ReAct system prompts, English and Chinese, and a
line of accents, digits and emoji), then adds the ChatML special tokens
``<|im_start|>``, ``<|im_end|>`` and ``<|endoftext|>``. The config names
them as Qwen2.5's does: eos ``<|im_end|>``, pad ``<|endoftext|>``, no bos.
Needs the ``tokenizers`` package; the port reads the result without it.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "scripts")]

from tokenizers import Tokenizer  # noqa: E402
from train_tiny_agent import train_bpe_tokenizer  # noqa: E402

from opsagent_tpu.agent.prompts import (  # noqa: E402
    DIAGNOSE_SYSTEM_PROMPT,
    EXECUTE_SYSTEM_PROMPT_CN,
    REACT_SYSTEM_PROMPT,
)

VOCAB_SIZE = 1024
CHATML = ["<|im_start|>", "<|im_end|>", "<|endoftext|>"]
EXTRA = (REACT_SYSTEM_PROMPT, EXECUTE_SYSTEM_PROMPT_CN, DIAGNOSE_SYSTEM_PROMPT,
         "Café déjà vu: naïve façade, 12345 pods, 3.14 GiB, ünïcödé; 你好世界 🚀✨ "
         "It's, we'll, they're, I'd, you've, I'm.")


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        tok = Tokenizer.from_file(os.path.join(
            train_bpe_tokenizer(tmp, EXTRA, vocab_size=VOCAB_SIZE), "tokenizer.json"))
    tok.add_special_tokens(CHATML)
    tok.save(os.path.join(HERE, "tokenizer.json"))
    with open(os.path.join(HERE, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": None, "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
            "additional_special_tokens": ["<bos>", "<eos>", "<pad>", *CHATML],
            "clean_up_tokenization_spaces": False,
        }, f, indent=2)
        f.write("\n")


if __name__ == "__main__":
    main()
