"""Serving reliability: the error classes, retry/deadline/circuit-breaker
policies and the health monitor."""

from .health import HealthMonitor, RefitCandidate
from .policy import (
    BreakerBoard,
    ChainedRequestError,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    ReliabilityPolicy,
    RetryPolicy,
    StateIntegrityError,
    is_retryable,
)

__all__ = [
    "BreakerBoard",
    "ChainedRequestError",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "HealthMonitor",
    "RefitCandidate",
    "ReliabilityPolicy",
    "RetryPolicy",
    "StateIntegrityError",
    "is_retryable",
]
