"""Serving layer of the port: the continuous-batching engine over the
paged KV cache."""
from .engine import ContinuousBatchingEngine, ServeRequest

__all__ = ["ContinuousBatchingEngine", "ServeRequest"]
