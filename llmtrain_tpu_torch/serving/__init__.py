"""Inference serving (simple mode)."""

from .http import ServerState, ServerStats, make_server

__all__ = ["ServerState", "ServerStats", "make_server"]
