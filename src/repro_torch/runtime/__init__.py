"""Fault tolerance: heartbeat, straggler monitor, the resilient step loop."""

from repro_torch.runtime.fault_tolerance import (Heartbeat, StragglerMonitor,  # noqa: F401
                                                 run_resilient)
