"""Serving layer of the port: the continuous-batching engine over the
paged KV cache, and its speculative drafters."""
from .engine import ContinuousBatchingEngine, ServeRequest
from .speculative import (AdaptiveSpecPolicy, Drafter, DraftModelDrafter,
                          NGramDrafter)

__all__ = ["ContinuousBatchingEngine", "ServeRequest", "AdaptiveSpecPolicy",
           "Drafter", "DraftModelDrafter", "NGramDrafter"]
