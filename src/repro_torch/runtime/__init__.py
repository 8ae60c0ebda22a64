from .fault import (  # noqa: F401
    ElasticPolicy, FaultInjector, HeartbeatRegistry, ReplicaFault, StepMonitor, TrainDriver,
)
