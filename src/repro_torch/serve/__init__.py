"""Serving: continuous-batching engine, schedulers, sampler, telemetry.

The HTTP front door is ``repro_torch.serve.server.ServeHTTPServer``.
"""

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import EngineStats, RequestResult, ServeEngine
from repro_torch.serve.metrics import Telemetry
from repro_torch.serve.sampler import make_sampler, sample_token
from repro_torch.serve.scheduler import DeadlineScheduler, FifoScheduler, Request

__all__ = ["ServeConfig", "ServeEngine", "EngineStats", "RequestResult",
           "FifoScheduler", "DeadlineScheduler", "Request", "Telemetry",
           "make_sampler", "sample_token"]
