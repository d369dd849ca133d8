"""Fault-aware continuous-batching inference runtime.

    from repro_torch.serving import FaultTolerantServer, ServerConfig

    srv = FaultTolerantServer(ServerConfig(mode="protected", dispatch="fused"))
    srv.submit([1, 2, 3], max_new_tokens=8)
    summary = srv.run(max_steps=64)
"""
from repro_torch.obs.events import EventLog  # noqa: F401
from repro_torch.serving.fault_manager import (  # noqa: F401
    CONFIRMED,
    HEALTHY,
    REMAPPED,
    REPAIRED,
    RETIRED,
    SUSPECT,
    FaultInjector,
    FaultManager,
    FaultManagerConfig,
)
from repro_torch.serving.metrics import ServingMetrics, StepRecord  # noqa: F401
from repro_torch.serving.queue import CompletedRequest, Request, RequestQueue  # noqa: F401
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Slot  # noqa: F401
from repro_torch.serving.server import FaultTolerantServer, ModelBundle, ServerConfig  # noqa: F401
