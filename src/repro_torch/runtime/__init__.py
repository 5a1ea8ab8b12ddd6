"""Training runtime: the supervisor's checkpoint/restart loop."""
from .fault_tolerance import StragglerMonitor, TrainSupervisor

__all__ = ["StragglerMonitor", "TrainSupervisor"]
