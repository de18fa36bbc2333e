"""Error classes of the serving slice."""

from .policy import (
    ChainedRequestError,
    DeadlineExceededError,
    StateIntegrityError,
)

__all__ = [
    "ChainedRequestError",
    "DeadlineExceededError",
    "StateIntegrityError",
]
