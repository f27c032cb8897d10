"""Serving layer of the port: the continuous-batching engine over the
paged KV cache, its speculative drafters, and the fault-tolerant decode
fleet (`Fleet`, `FleetWorker`, `SubprocessWorker`) behind the SLO router
(`Router`, `Request`, `Rejected`); the kernel build cache as its compile
cache (`enable_compile_cache`, `cache_dir`)."""
from .compile_cache import cache_dir, enable_compile_cache
from .engine import ContinuousBatchingEngine, ServeRequest
from .fleet import Fleet, FleetWorker, SubprocessWorker
from .router import Rejected, Request, Router
from .speculative import (AdaptiveSpecPolicy, Drafter, DraftModelDrafter,
                          NGramDrafter)

__all__ = ["ContinuousBatchingEngine", "ServeRequest", "AdaptiveSpecPolicy",
           "Drafter", "DraftModelDrafter", "NGramDrafter", "Fleet",
           "FleetWorker", "SubprocessWorker", "Rejected", "Request",
           "Router", "cache_dir", "enable_compile_cache"]
