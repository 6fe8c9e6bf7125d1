"""Serving: batched decode engine."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
