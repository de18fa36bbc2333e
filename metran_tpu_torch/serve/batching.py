"""Micro-batching: coalesce concurrent requests into one device dispatch.

Port of ``metran_tpu/serve/batching.py`` (pure threading, unchanged).

Serving-heavy traffic means many small concurrent requests against many
models; dispatching each alone wastes the accelerator (a (1, ...) batch
pays the same launch latency as a (256, ...) one).  The
:class:`MicroBatcher` holds each incoming request for at most
``flush_deadline`` seconds, grouping by *batch key* — (kind, shape
bucket, horizon/k) — so everything in a group is servable by ONE
kernel launch, then hands the whole group to the dispatch
callback as a single batch.  A group also flushes early the moment it
reaches ``max_batch``.

The batcher is transport-agnostic: callers get ``concurrent.futures.
Future``\\ s, the dispatch callback resolves them.  ``flush_deadline=
None`` disables the background flusher entirely — requests then only
move on explicit :meth:`flush` (deterministic mode: tests, and callers
that already aggregate upstream).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from logging import getLogger
from typing import Any, Callable, Dict, Hashable, List, Optional

logger = getLogger(__name__)


@dataclass
class Request:
    """One queued request; ``payload`` is opaque to the batcher.

    ``trace`` is an equally opaque tracing handle the batcher carries
    across the thread boundary to the dispatch callback (contextvars
    cannot cross the worker thread).
    """

    model_id: str
    payload: Any
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)
    trace: Any = None


@dataclass
class _Group:
    requests: List[Request] = field(default_factory=list)
    first_at: float = 0.0
    # identity token handed to submit_tracked callers: a bare object()
    # rather than the group itself, so holding a token (the service
    # keeps one per model) cannot retain the whole batch of requests
    # and their results after dispatch
    token: object = field(default_factory=object)


class MicroBatcher:
    """Deadline/size-bounded request coalescing (see module docstring).

    Parameters
    ----------
    dispatch : ``dispatch(batch_key, requests) -> list`` returning one
        result per request IN ORDER (or raising — the exception then
        fails every future in the batch).  A returned item that IS a
        ``BaseException`` instance fails just that request's future:
        the partial-failure channel for dispatches whose side effects
        land per-request (an update batch where a later chained round
        raises must not fail the earlier rounds it already applied).
    flush_deadline : seconds a request may wait for co-batching
        (``None``: manual :meth:`flush` only, no background thread).
    max_batch : a group reaching this size flushes immediately.
    """

    def __init__(
        self,
        dispatch: Callable[[Hashable, List[Request]], List[Any]],
        flush_deadline: Optional[float] = 0.005,
        max_batch: int = 256,
    ):
        self._dispatch = dispatch
        self.flush_deadline = flush_deadline
        self.max_batch = int(max_batch)
        self._groups: Dict[Hashable, _Group] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._stopping = False  # worker exits; submits still accepted
        self._worker: Optional[threading.Thread] = None
        if flush_deadline is not None:
            self._worker = threading.Thread(
                target=self._run, name="metran-serve-batcher", daemon=True
            )
            self._worker.start()

    # ------------------------------------------------------------------
    def submit(
        self, batch_key: Hashable, model_id: str, payload,
        enqueued_at: Optional[float] = None, trace=None,
    ) -> Future:
        """Enqueue one request; resolve via the returned future.

        ``enqueued_at`` backdates the request's queue timestamp (a
        ``time.monotonic`` value) for callers that held it elsewhere
        first — a deferred update chained behind a predecessor — so
        latency telemetry covers the wait the caller actually saw.  A
        group started by a backdated request may flush immediately
        (its deadline is measured from the stamp), which only shortens
        an already-long wait.  ``trace`` rides the request to the
        dispatch callback (see :class:`Request`).
        """
        return self.submit_tracked(
            batch_key, model_id, payload, enqueued_at=enqueued_at,
            trace=trace,
        )[0]

    def submit_tracked(
        self, batch_key: Hashable, model_id: str, payload, join=None,
        enqueued_at: Optional[float] = None, trace=None,
    ):
        """Enqueue like :meth:`submit` and also return the pending group
        joined, as ``(future, group)`` with ``group`` an opaque identity
        token.

        With ``join`` set to a previously returned token, the request is
        enqueued ONLY if it would land in exactly that still-pending
        group (checked atomically under the batcher lock); otherwise
        nothing is enqueued and ``(None, None)`` comes back.  This is
        the primitive the service layer uses to decide whether two
        same-model requests are provably co-batchable inside one
        dispatch or must chain on each other's futures.
        """
        req = Request(model_id=model_id, payload=payload, trace=trace)
        if enqueued_at is not None:
            req.enqueued_at = float(enqueued_at)
        flush_now = None
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            group = self._groups.get(batch_key)
            if join is not None and (group is None or group.token is not join):
                return None, None
            if group is None:
                group = self._groups[batch_key] = _Group(
                    first_at=req.enqueued_at
                )
            group.requests.append(req)
            if len(group.requests) >= self.max_batch:
                flush_now = self._groups.pop(batch_key)
            else:
                self._wake.notify()
        if flush_now is not None:
            # size-triggered flush runs on the submitting thread: the
            # batch is already as full as it is allowed to get, waiting
            # for the worker would only add deadline latency
            self._fire(batch_key, flush_now.requests)
        return req.future, group.token

    def flush(self, batch_key: Optional[Hashable] = None) -> int:
        """Dispatch pending group(s) now; returns requests dispatched."""
        with self._lock:
            if batch_key is not None:
                groups = (
                    {batch_key: self._groups.pop(batch_key)}
                    if batch_key in self._groups else {}
                )
            else:
                groups, self._groups = self._groups, {}
        n = 0
        for key, group in groups.items():
            self._fire(key, group.requests)
            n += len(group.requests)
        return n

    def pending(self) -> int:
        with self._lock:
            return sum(len(g.requests) for g in self._groups.values())

    def oldest_wait(self) -> float:
        """Seconds the oldest still-queued request has waited — the
        queue-saturation signal next to :meth:`pending` (a deep queue
        of fresh requests is coalescing; an OLD head means dispatch
        is not keeping up).  0.0 when nothing is queued."""
        with self._lock:
            if not self._groups:
                return 0.0
            first = min(g.first_at for g in self._groups.values())
        return max(0.0, time.monotonic() - first)

    def worker_alive(self) -> bool:
        """Whether the background flusher can still dispatch deadlines.

        True in manual-flush mode (no worker to die — callers drive
        dispatch); in background mode, the liveness half of the service
        health probe: a dead worker means queued requests only ever
        resolve through explicit ``flush()``/caller deadlines.
        """
        if self.flush_deadline is None:
            return True
        with self._lock:
            if self._closed or self._stopping:
                return False
        return self._worker is not None and self._worker.is_alive()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        """Flush everything and stop the background worker.

        Ordered so chained follow-ups still drain: first stop the
        worker while KEEPING submits open (an in-flight dispatch's
        done-callbacks may enqueue deferred successors — see the
        service layer's per-model ordering), then flush to empty, and
        only then refuse new submissions."""
        with self._lock:
            self._stopping = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        while self.flush():
            pass  # each pass can enqueue deferred follow-ups
        with self._lock:
            self._closed = True
        self.flush()  # anything that raced in between draining and closing

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    @staticmethod
    def _resolve_future(future: Future, result=None, exc=None) -> None:
        """Set a claimed future's outcome, tolerating races.

        The future was claimed via ``set_running_or_notify_cancel``
        before dispatch, so caller-side ``cancel()`` can no longer win;
        the guards stay as a belt against anything that resolved it
        another way — an unguarded setter raising on the flusher thread
        would kill it and hang every subsequent request.
        """
        try:
            if future.done():
                return
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:  # raced: someone else resolved it first
            logger.debug("dropping result for an already-resolved request")

    def _fire(self, batch_key, requests: List[Request]) -> None:
        # executor semantics: claim every future BEFORE dispatching.  A
        # request whose caller already cancelled it is dropped here, so
        # a successful cancel() guarantees the request produced no side
        # effects (an update cancelled-but-still-applied would make the
        # caller resubmit and assimilate the same observations twice).
        live = [
            req for req in requests
            if req.future.set_running_or_notify_cancel()
        ]
        if not live:
            return
        try:
            results = self._dispatch(batch_key, live)
            if len(results) != len(live):
                raise RuntimeError(
                    f"dispatch returned {len(results)} results for "
                    f"{len(live)} requests (key {batch_key})"
                )
        except BaseException as exc:  # noqa: BLE001 — fail the futures
            for req in live:
                self._resolve_future(req.future, exc=exc)
            return
        for req, res in zip(live, results):
            if isinstance(res, BaseException):  # per-request failure
                self._resolve_future(req.future, exc=res)
            else:
                self._resolve_future(req.future, result=res)

    def _run(self) -> None:
        """Background flusher: wake at the earliest group deadline."""
        while True:
            due: List = []
            with self._lock:
                while not (self._closed or self._stopping):
                    now = time.monotonic()
                    deadlines = [
                        g.first_at + self.flush_deadline
                        for g in self._groups.values()
                    ]
                    if deadlines and min(deadlines) <= now:
                        break
                    self._wake.wait(
                        timeout=(min(deadlines) - now) if deadlines else None
                    )
                if self._closed or self._stopping:
                    return
                now = time.monotonic()
                for key in list(self._groups):
                    group = self._groups[key]
                    if group.first_at + self.flush_deadline <= now:
                        due.append((key, self._groups.pop(key)))
            for key, group in due:
                self._fire(key, group.requests)


__all__ = ["MicroBatcher", "Request"]
