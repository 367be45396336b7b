from repro_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                        ServingStats)

__all__ = ["ContinuousBatchingEngine", "Request", "ServingStats"]
