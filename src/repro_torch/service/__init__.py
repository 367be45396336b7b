"""Fault-tolerant campaign service (DESIGN.md §10).

A server-shaped front end over the experiment registry: requests in,
validated-or-degraded responses out — deduplicated, retried with
deterministic backoff, routed around broken backends by circuit
breakers, and spot-checked against the timing oracle.  Fault injection
(`FaultInjectingBackend`) makes every one of those paths testable.
"""
from repro_torch.service.campaign import (CampaignService, ExperimentRequest,
                                    ServiceResponse, ServiceStats)
from repro_torch.service.faults import (CORRUPT_SCALE, FAULT_KINDS, Fault,
                                  FaultInjectingBackend, FaultScript,
                                  register_fault_injected)
from repro_torch.service.retry import (CircuitBreaker, CircuitOpenError,
                                 RetryPolicy)

__all__ = [
    "CampaignService", "ExperimentRequest", "ServiceResponse",
    "ServiceStats", "Fault", "FaultScript", "FaultInjectingBackend",
    "register_fault_injected", "FAULT_KINDS", "CORRUPT_SCALE",
    "RetryPolicy", "CircuitBreaker", "CircuitOpenError",
]
