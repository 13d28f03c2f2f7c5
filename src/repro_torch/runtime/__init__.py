"""Fault injection and fault tolerance of the sweep orchestrator, PyTorch
port of ``repro.runtime``."""
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,  # noqa
                                                 StepRunner, ElasticPlanner)
from repro_torch.runtime.faults import (FaultError, InjectedTransient,  # noqa
                                        InjectedDeviceLoss, InjectedKill,
                                        LogicalClock, FaultEvent, FaultPlan,
                                        seeded_plan, corrupt_checkpoint)
