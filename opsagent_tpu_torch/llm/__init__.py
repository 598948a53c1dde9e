"""The port's LLM client (a copy of ``opsagent_tpu/llm/client.py``)."""

from .client import ChatClient, LLMError, register_provider

__all__ = ["ChatClient", "LLMError", "register_provider"]
