"""The port's LLM client and token accounting (copies of
``opsagent_tpu/llm/client.py`` and ``opsagent_tpu/llm/tokens.py``)."""

from .client import ChatClient, LLMError, register_provider
from .tokens import (
    constrict_messages,
    constrict_prompt,
    get_token_limits,
    num_tokens_from_messages,
)

__all__ = [
    "ChatClient",
    "LLMError",
    "register_provider",
    "get_token_limits",
    "num_tokens_from_messages",
    "constrict_messages",
    "constrict_prompt",
]
