"""The operational fault model: the seeded churn, link-drop and straggler
schedule, the round program's fault spec, and the distributed backend's
injector that SIGKILLs and respawns node processes on that schedule."""

from murmura_tpu_torch.faults.injector import FaultInjector
from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec

__all__ = ["FaultSchedule", "FaultSpec", "FaultInjector"]
