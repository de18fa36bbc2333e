"""Error classes the serving slice raises (same names and meanings as
the JAX package's ``reliability/policy.py``)."""

from __future__ import annotations


class StateIntegrityError(RuntimeError):
    """A posterior state is corrupt or numerically invalid.

    Raised when an on-disk state fails its checksum or cannot be parsed,
    and when an assimilation step produces a non-finite or non-PSD
    posterior (the update is then rejected and the stored state left
    unchanged).  Deterministic — never retried.
    """


class ChainedRequestError(RuntimeError):
    """A request was not applied because its predecessor failed.

    Same-model updates form an ordered chain (the Kalman recursion is
    order-dependent); once one link fails, applying its successors would
    silently skip observations, so they fail with this error instead.
    """


class DeadlineExceededError(TimeoutError):
    """A synchronous service call hit its hard deadline.

    ``in_flight`` is True when the request could no longer be cancelled
    (a dispatch already claimed it): the operation MAY still complete,
    so an update must not be blindly retried — check the version first.
    """

    def __init__(self, kind: str, model_id: str, deadline_s: float,
                 in_flight: bool):
        self.kind = kind
        self.model_id = model_id
        self.deadline_s = deadline_s
        self.in_flight = in_flight
        state = (
            "request still in flight" if in_flight
            else "request cancelled, no side effect"
        )
        super().__init__(
            f"{kind} for model {model_id!r} exceeded its "
            f"{deadline_s:.3f}s deadline ({state})"
        )
