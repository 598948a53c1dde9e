"""The agent loops (the port's copies of ``opsagent_tpu/agent``): the ReAct
loop with its conveyor, and the function-calling loop."""

from .funcall import AgentFunction, run_function_agent
from .react import assistant, assistant_with_config

__all__ = ["assistant", "assistant_with_config", "AgentFunction", "run_function_agent"]
