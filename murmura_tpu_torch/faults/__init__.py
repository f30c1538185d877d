"""The operational fault model: the seeded churn, link-drop and straggler
schedule and the round program's fault spec."""

from murmura_tpu_torch.faults.schedule import FaultSchedule, FaultSpec

__all__ = ["FaultSchedule", "FaultSpec"]
