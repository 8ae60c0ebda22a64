from .fault import (  # noqa: F401
    FaultInjector, HeartbeatRegistry, ReplicaFault, StepMonitor,
)
