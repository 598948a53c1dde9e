"""The agent's REST server (the port's counterpart of
``opsagent_tpu/server``): JWT login, the agent routes and the observability
routes over the standard library's threading HTTP server."""

from .app import build_server, run_server

__all__ = ["build_server", "run_server"]
