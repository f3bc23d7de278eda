"""Serving: continuous-batching engine, FIFO scheduler, greedy sampler."""

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import EngineStats, RequestResult, ServeEngine
from repro_torch.serve.scheduler import FifoScheduler, Request

__all__ = ["ServeConfig", "ServeEngine", "EngineStats", "RequestResult",
           "FifoScheduler", "Request"]
