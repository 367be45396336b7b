from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop, HealthSource,
                                           MeshLadder, SimulatedHealth,
                                           StragglerDetector)

__all__ = ["FaultTolerantLoop", "HealthSource", "MeshLadder",
           "SimulatedHealth", "StragglerDetector"]
