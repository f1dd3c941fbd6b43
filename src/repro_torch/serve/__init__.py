"""Serving layer (mirrors ``repro.serve``): the LM decode engine with
continuous batching, the dynamic-walk engine, its ingestion guard, the
continuous-serving scheduler and the crash-exact WAL/snapshot recovery
wrapper."""

from repro_torch.serve.dynwalk import DynamicWalkEngine
from repro_torch.serve.engine import DecodeEngine, ServeRequest
from repro_torch.serve.guard import GuardPolicy, IngestGuard
from repro_torch.serve.recovery import RecoverableEngine, WriteAheadLog
from repro_torch.serve.scheduler import (SchedulerConfig, ServingScheduler,
                                         WalkResult, replay_admission_trace)

__all__ = ["DecodeEngine", "DynamicWalkEngine", "ServeRequest",
           "GuardPolicy", "IngestGuard", "RecoverableEngine",
           "WriteAheadLog", "SchedulerConfig", "ServingScheduler",
           "WalkResult", "replay_admission_trace"]
