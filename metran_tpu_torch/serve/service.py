"""`MetranService`: the in-process serving API of the port.

Port of the core of the JAX package's ``serve/service.py``::

    update(model_id, new_obs) ─┐                       ┌─> K1 launch
                               ├─> MicroBatcher ──────>┤   (K9 on sqrt;
    forecast(model_id, steps) ─┘    (group by          └─> K2 launch
                                     bucket+horizon)        one per group)

- Requests take and return **data units**; standardization happens at
  submit with each model's stored scaler constants.
- ``update`` assimilates ``k`` new rows (NaN = missing) through the
  incremental filter and bumps the model's version; ``forecast`` returns
  closed-form predictive moments from the warm posterior.
- Two updates to one model inside one flush apply in order (dispatch
  rounds), and a model's update chains on its unresolved predecessor
  unless both provably share one batcher group.
- A request fails ALONE: payloads are validated at submit, and each
  batch slot's posterior passes the integrity gate before
  ``registry.put`` — a poisoned model fails its own request while the
  other slots of the same launch commit.
- A ``ModelRegistry(engine="sqrt")`` assimilates in factored form:
  the stacked factors go through K9, each slot's factor is committed
  beside its reconstituted covariance, and the gate is a finiteness
  check.

The dispatch runs on the service's device (default: the CUDA card).
Breakers, retries, the observation gate, the read path, steady-state
serving, detection, robust updates, refit, durability, the cluster and
observability layers come in later slices (ROADMAP A4, A7).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from logging import getLogger
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device, serve_defaults
from ..reliability.policy import (
    ChainedRequestError,
    DeadlineExceededError,
    StateIntegrityError,
)
from .batching import MicroBatcher
from .engine import posterior_fault, stack_bucket, state_slot_index
from .registry import ModelRegistry
from .state import PosteriorState

logger = getLogger(__name__)

#: hard cap on any synchronous call, seconds (``None`` disables)
REQUEST_DEADLINE_S = 30.0


def _transfer(src: Future, dst: Future) -> None:
    """Mirror one future's outcome onto another (chained submissions)."""
    if dst.done():
        return
    if src.cancelled():
        dst.cancel()
    elif src.exception() is not None:
        dst.set_exception(src.exception())
    else:
        dst.set_result(src.result())


class _ChainedFuture(Future):
    """Caller-visible future for an update whose batcher submission may
    happen later than the call that created it (a deferred request
    enqueues only once its same-model predecessor resolves).

    ``cancel()`` is atomic with that hand-off: either it wins while
    nothing was enqueued, or it propagates to the inner batcher request
    and succeeds only if THAT request could still be cancelled.  A
    successful cancel proves the observations were never assimilated.
    """

    def __init__(self):
        super().__init__()
        self._chain_lock = threading.RLock()
        self._inner: Optional[Future] = None
        self._detached = False  # a cancel won before any submission

    def attach_inner(self, submit):
        """Run ``submit()`` (returning ``(inner_future, token)``) unless
        this future is resolved or a cancel won; record the inner future.
        Returns ``submit()``'s result, or ``None`` when nothing was
        enqueued."""
        with self._chain_lock:
            if self._detached or self.done():
                return None
            out = submit()
            if out[0] is not None:
                self._inner = out[0]
            return out

    def cancel(self) -> bool:
        with self._chain_lock:
            inner = self._inner
            if inner is None:
                self._detached = True
        if inner is None:
            return super().cancel() or self.cancelled()
        if inner.cancel() or inner.cancelled():
            super().cancel()
            return True
        return False


class _PendingUpdate:
    """One model's most recent update in flight: its batch key, future,
    batcher group token (``None`` while deferred) and the unresolved
    predecessor it chained on."""

    __slots__ = ("key", "future", "group", "prior")

    def __init__(self, key, future: _ChainedFuture, prior=None):
        self.key = key
        self.future = future
        self.group = None
        self.prior = prior


class Forecast(NamedTuple):
    """Forecast of one model, data units: ``means``/``variances`` are
    (steps, n_series); ``version`` the posterior version served."""

    means: np.ndarray
    variances: np.ndarray
    names: Tuple[str, ...]
    version: int


class MetranService:
    """Query-able, incrementally-updatable serving front end.

    Parameters
    ----------
    registry : model storage + shape buckets.
    flush_deadline : seconds a request may wait to co-batch (``None``:
        requests dispatch on :meth:`flush`, the deterministic mode).
        Default from :func:`metran_tpu_torch.config.serve_defaults`.
    max_batch : dispatch immediately once a group is this full.
    persist_updates : write updated states through to the registry's
        disk root (ignored for in-memory registries).
    device : where the kernels run (default: the CUDA card; without one
        construction raises — pass ``device="cpu"`` for the CPU).
    """

    def __init__(self, registry: ModelRegistry,
                 flush_deadline: Optional[float] = "default",
                 max_batch: Optional[int] = None,
                 persist_updates: bool = True, device=None):
        self.device = resolve_device(device)
        defaults = serve_defaults()
        if flush_deadline == "default":
            flush_deadline = defaults["flush_deadline_s"]
        if max_batch is None:
            max_batch = defaults["max_batch"]
        self.registry = registry
        self.persist_updates = persist_updates
        self.deadline_s = REQUEST_DEADLINE_S
        self._stats: Counter = Counter()
        self._stats_lock = threading.Lock()
        # one lock around each assimilation round keeps every model's
        # read -> compute -> put sequential across dispatch threads
        self._update_lock = threading.Lock()
        # guards only the per-model ordering bookkeeping; batcher
        # submissions happen after it is released (a size-triggered
        # flush dispatches inline and its callbacks re-take this lock)
        self._order_lock = threading.Lock()
        self._last_update: dict = {}  # model_id -> _PendingUpdate
        self.batcher = MicroBatcher(
            self._dispatch, flush_deadline=flush_deadline,
            max_batch=max_batch,
        )

    # ------------------------------------------------------------------
    def _count(self, kind: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[kind] += n

    @property
    def stats(self) -> dict:
        """Lifetime counters: validation errors, poisoned updates and
        forecasts (integrity-gate rejections), chain failures, masked
        cells, empty updates, ..."""
        with self._stats_lock:
            return dict(self._stats)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def forecast(self, model_id: str, steps: int,
                 deadline: Optional[float] = "default") -> Forecast:
        """Predictive means/variances ``steps`` grid periods ahead,
        bounded by ``deadline`` seconds."""
        return self._call(
            "forecast", model_id,
            lambda: self.forecast_async(model_id, steps), deadline,
        )

    def forecast_async(self, model_id: str,
                       steps: int) -> "Future[Forecast]":
        steps = int(steps)
        if steps < 1:
            self._count("validation_errors")
            raise ValueError(f"forecast steps must be >= 1, got {steps}")
        state = self.registry.get(model_id)
        bucket = self.registry.bucket_of(state)
        return self.batcher.submit(("forecast", bucket, steps), model_id,
                                   None)

    def update(self, model_id: str, new_obs,
               deadline: Optional[float] = "default") -> PosteriorState:
        """Assimilate ``new_obs`` ((k, n_series), data units, NaN =
        missing) and return the bumped :class:`PosteriorState`."""
        return self._call(
            "update", model_id,
            lambda: self.update_async(model_id, new_obs), deadline,
        )

    def update_async(self, model_id: str,
                     new_obs) -> "Future[PosteriorState]":
        state = self.registry.get(model_id)
        new_obs = np.atleast_2d(np.asarray(new_obs, float))
        if new_obs.shape[1] != state.n_series:
            self._count("validation_errors")
            raise ValueError(
                f"new_obs has {new_obs.shape[1]} series, model "
                f"{model_id!r} has {state.n_series}"
            )
        if np.isinf(new_obs).any():
            # NaN marks a missing observation; an infinity is never data
            self._count("validation_errors")
            raise ValueError(
                f"new_obs for model {model_id!r} contains infinite "
                "values; use NaN to mark missing observations"
            )
        mask = np.isfinite(new_obs)
        n_masked = int(mask.size - np.count_nonzero(mask))
        if n_masked:
            self._count("masked_values", n_masked)
        y_std = np.where(
            mask, (new_obs - state.scaler_mean) / state.scaler_std, 0.0
        )
        bucket = self.registry.bucket_of(state)
        key = ("update", bucket, new_obs.shape[0])
        out = self._enqueue_update(model_id, key, (y_std, mask),
                                   time.monotonic())
        # drop the ordering entry once resolved (registered outside
        # _order_lock: a done future runs the callback inline)
        out.add_done_callback(lambda _f: self._forget_entry(model_id, out))
        return out

    def _call(self, kind: str, model_id: str, submit, deadline):
        """Sync-call engine: submit, then wait under a hard deadline."""
        deadline_s = self.deadline_s if deadline == "default" else deadline
        t_end = None if deadline_s is None else time.monotonic() + deadline_s
        fut = submit()
        try:
            return self._resolve(fut, t_end)
        except _FutureTimeout as exc:
            if fut.done() and not fut.cancelled() and fut.exception() is exc:
                raise  # the dispatch itself raised a TimeoutError
            in_flight = not fut.cancel()
            self._count("deadline_exceeded")
            raise DeadlineExceededError(
                kind, model_id, deadline_s, in_flight=in_flight
            ) from None

    def _resolve(self, fut: Future, t_end: Optional[float] = None):
        """Wait for a sync call's future; in manual-flush mode nobody
        else dispatches, so drain the batcher first (a pass at a time:
        a deferred update enters it only once its predecessor
        resolved)."""
        if self.batcher.flush_deadline is None:
            while not fut.done():
                if t_end is not None and time.monotonic() >= t_end:
                    break
                if self.batcher.flush() == 0:
                    break
        if t_end is None:
            return fut.result()
        return fut.result(timeout=max(t_end - time.monotonic(), 0.0))

    # ------------------------------------------------------------------
    # per-model ordering
    # ------------------------------------------------------------------
    def _forget_entry(self, model_id, future) -> None:
        """Drop a RESOLVED entry from ``_last_update``, reinstating the
        nearest unresolved ancestor when one is still pending."""
        with self._order_lock:
            cur = self._last_update.get(model_id)
            if cur is None or cur.future is not future:
                return
            anc = cur.prior
            while anc is not None and anc.future.done():
                anc = anc.prior
            if anc is not None:
                self._last_update[model_id] = anc
            else:
                del self._last_update[model_id]

    def _enqueue_update(self, model_id, key, payload, t_submit) -> Future:
        """Enqueue one validated update, preserving per-model order:
        join the predecessor's still-pending batcher group when both
        share a batch key, else chain on the predecessor's future."""
        fut = _ChainedFuture()
        with self._order_lock:
            prior = self._last_update.get(model_id)
            while prior is not None and prior.future.done():
                prior = prior.prior
            join = (
                prior.group
                if prior is not None and prior.key == key else None
            )
            entry = _PendingUpdate(key, fut, prior=prior)
            self._last_update[model_id] = entry
        if prior is None:
            self._attach_and_wire(entry, model_id, payload, t_submit)
            return fut
        if join is not None:
            outcome = self._attach_and_wire(
                entry, model_id, payload, t_submit, join=join
            )
            if outcome != "join_missed":
                return fut

        def _enqueue(prior_done):
            if fut.done():
                return
            if prior_done.cancelled():
                # a cancelled link had no side effect: re-defer on the
                # nearest live ancestor so this update cannot overtake it
                anc = entry.prior
                while anc is not None:
                    if anc.future.cancelled():
                        anc = anc.prior
                        continue
                    if not anc.future.done():
                        anc.future.add_done_callback(_enqueue)
                        return
                    if anc.future.exception() is not None:
                        prior_done = anc.future
                    break
            if (
                not prior_done.cancelled()
                and prior_done.exception() is not None
            ):
                # the predecessor was not applied: applying this one
                # would skip observations mid-stream
                self._count("chain_failures")
                try:
                    fut.set_exception(ChainedRequestError(
                        f"update for model {model_id!r} not applied: its "
                        f"predecessor failed ({prior_done.exception()!r})"
                    ))
                except Exception:  # raced with a cancel
                    pass
                return
            try:
                self._attach_and_wire(entry, model_id, payload, t_submit)
            except BaseException:  # e.g. batcher closed
                return  # fut already resolved with the failure

        prior.future.add_done_callback(_enqueue)
        return fut

    def _attach_and_wire(self, entry, model_id, payload, t_submit,
                         join=None) -> str:
        """Submit the entry's update through its future's cancel-atomic
        ``attach_inner``.  Returns ``"enqueued"``, ``"cancelled"`` or
        ``"join_missed"``; a batcher refusal resolves the entry with the
        failure before re-raising, so successors chain-break."""
        fut = entry.future
        try:
            out = fut.attach_inner(
                lambda: self.batcher.submit_tracked(
                    entry.key, model_id, payload, join=join,
                    enqueued_at=t_submit,
                )
            )
        except BaseException as exc:
            try:
                if not fut.done():
                    fut.set_exception(exc)
            except Exception:  # raced with a cancel
                pass
            self._forget_entry(model_id, fut)
            raise
        if out is None:
            return "cancelled"
        inner, group = out
        if inner is None:
            return "join_missed"
        entry.group = group
        inner.add_done_callback(lambda f: _transfer(f, fut))
        return "enqueued"

    def flush(self) -> int:
        """Dispatch everything pending now, draining deferred same-model
        follow-ups too."""
        total = 0
        while True:
            n = self.batcher.flush()
            total += n
            if n == 0:
                return total

    # ------------------------------------------------------------------
    # bulk API (per-request path on a dict registry)
    # ------------------------------------------------------------------
    def update_batch(self, model_ids, new_obs) -> list:
        """One fleet tick: ``k`` rows for G distinct models.  Returns one
        :class:`PosteriorState` or exception per model, in order."""
        ids = [str(m) for m in model_ids]
        if len(set(ids)) != len(ids):
            raise ValueError(
                "update_batch model_ids must be distinct (duplicate "
                "ticks for one model have no defined order inside one "
                "dispatch)"
            )
        if isinstance(new_obs, np.ndarray) and new_obs.ndim == 3:
            obs_list = list(np.asarray(new_obs, float))
        else:
            obs_list = [np.atleast_2d(np.asarray(o, float)) for o in new_obs]
        if len(obs_list) != len(ids):
            raise ValueError(
                f"got {len(ids)} model_ids but {len(obs_list)} "
                "observation blocks"
            )
        ks = {o.shape[0] for o in obs_list}
        if len(ks) > 1:
            raise ValueError(
                "all observation blocks in one tick must append the "
                f"same k rows; got {sorted(ks)}"
            )
        return self._batch_via_requests(
            ids, [("update", o) for o in obs_list]
        )

    def forecast_batch(self, model_ids, steps: int) -> list:
        """Forecast G models ``steps`` periods ahead; one
        :class:`Forecast` or exception per model, in order."""
        ids = [str(m) for m in model_ids]
        steps = int(steps)
        if steps < 1:
            self._count("validation_errors")
            raise ValueError(f"forecast steps must be >= 1, got {steps}")
        return self._batch_via_requests(ids, [("forecast", steps)] * len(ids))

    def _batch_via_requests(self, ids, specs) -> list:
        futs: list = []
        for mid, spec in zip(ids, specs):
            try:
                if spec[0] == "update":
                    futs.append(self.update_async(mid, spec[1]))
                else:
                    futs.append(self.forecast_async(mid, spec[1]))
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                futs.append(exc)
        if self.batcher.flush_deadline is None:
            self.flush()
        out: list = []
        for f in futs:
            if isinstance(f, Exception):
                out.append(f)
                continue
            try:
                out.append(f.result(timeout=self.deadline_s))
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                out.append(exc)
        return out

    def close(self) -> None:
        """Drain everything pending, then refuse new submissions."""
        self.batcher.close()

    def __enter__(self) -> "MetranService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # dispatch (runs on the batcher's flushing thread)
    # ------------------------------------------------------------------
    def _dispatch(self, batch_key, requests):
        kind, bucket, horizon = batch_key
        if kind == "forecast":
            return self._run_forecast(bucket, int(horizon), requests)
        if kind != "update":  # pragma: no cover - service-built keys
            raise ValueError(f"unknown dispatch kind {kind!r}")
        # several updates for one model in one batch chain in rounds:
        # round r carries each model's r-th request, one launch each
        rounds: list = []
        seen: dict = {}
        for pos, req in enumerate(requests):
            r = seen.get(req.model_id, 0)
            seen[req.model_id] = r + 1
            while len(rounds) <= r:
                rounds.append([])
            rounds[r].append(pos)
        results = [None] * len(requests)
        with self._update_lock:
            failed = None
            broken: set = set()  # models whose per-slot chain broke
            for positions in rounds:
                if failed is not None:
                    # earlier rounds were applied; fail only the rest
                    for p in positions:
                        self._count("chain_failures")
                        results[p] = ChainedRequestError(
                            f"update for model "
                            f"{requests[p].model_id!r} not applied: an "
                            f"earlier update in this batch failed "
                            f"({failed!r})"
                        )
                    continue
                live = []
                for p in positions:
                    if requests[p].model_id in broken:
                        self._count("chain_failures")
                        results[p] = ChainedRequestError(
                            f"update for model {requests[p].model_id!r} "
                            "not applied: an earlier update in this "
                            "batch failed"
                        )
                    else:
                        live.append(p)
                if not live:
                    continue
                try:
                    round_results = self._run_update(
                        bucket, int(horizon), [requests[p] for p in live]
                    )
                except BaseException as exc:  # noqa: BLE001
                    failed = exc
                    for p in live:
                        results[p] = failed
                    continue
                for p, res in zip(live, round_results):
                    results[p] = res
                    if isinstance(res, BaseException):
                        broken.add(requests[p].model_id)
        return results

    def _lookup_states(self, requests, results):
        """Per-request registry reads; an unreadable model fails its own
        slot and leaves the batch serviceable."""
        states, live = [], []
        for j, req in enumerate(requests):
            try:
                states.append(self.registry.get(req.model_id))
                live.append(j)
            except Exception as exc:  # noqa: BLE001 - per-slot channel
                self._count("lookup_failures")
                results[j] = exc
        return states, live

    def _run_forecast(self, bucket, steps: int, requests):
        """One batched forecast (one K2 launch); a slot whose moments
        come out non-finite fails alone."""
        results: list = [None] * len(requests)
        states, live = self._lookup_states(requests, results)
        if not live:
            return results
        batch = stack_bucket(states, bucket, device=self.device)
        fn = self.registry.forecast_fn(bucket, steps)
        means, variances = fn(batch.ss, batch.mean, batch.cov)
        means, variances = means.cpu().numpy(), variances.cpu().numpy()
        for i, (st, j) in enumerate(zip(states, live)):
            n = st.n_series
            m = means[i, :, :n]
            v = variances[i, :, :n]
            if not (np.all(np.isfinite(m)) and np.all(np.isfinite(v))):
                self._count("poisoned_forecasts")
                results[j] = StateIntegrityError(
                    f"forecast for model {st.model_id!r} produced "
                    "non-finite moments (poisoned posterior state)"
                )
                continue
            results[j] = Forecast(
                means=m * st.scaler_std + st.scaler_mean,
                variances=v * st.scaler_std**2,
                names=st.names,
                version=st.version,
            )
        return results

    def _run_update(self, bucket, k: int, requests):
        """One batched assimilation (one K1 launch, or one K9 launch on a
        square-root registry) over distinct-model requests: read each
        model's current state, write the bumped one.
        Callers hold ``_update_lock``.  A slot whose posterior fails the
        integrity gate gets :class:`StateIntegrityError` and its stored
        state stays as it was, while the healthy slots commit."""
        results: list = [None] * len(requests)
        states, live = self._lookup_states(requests, results)
        if not live:
            return results
        # square-root registries assimilate in factored form: the kernel
        # carries Cholesky factors, the posterior gate collapses to a
        # finiteness check (PSD by construction), and a covariance-form
        # state is migrated to a factor once (stack_bucket) and stays
        # factored thereafter
        sqrt_engine = self.registry._sqrt_engine
        batch = stack_bucket(states, bucket, device=self.device,
                             sqrt=sqrt_engine)
        n_pad = bucket[0]
        dtype = states[0].dtype
        y = np.zeros((len(states), k, n_pad), dtype)
        m = np.zeros((len(states), k, n_pad), bool)
        for i, st in enumerate(states):
            y_std, mask = requests[live[i]].payload
            y[i, :, : st.n_series] = y_std
            m[i, :, : st.n_series] = mask
        fn = self.registry.update_fn(bucket, k)
        mean_t, fac_t, sigma_t, detf_t = (
            t.cpu().numpy() for t in fn(
                batch.ss, batch.mean,
                batch.chol if sqrt_engine else batch.cov,
                torch.from_numpy(y).to(self.device),
                torch.from_numpy(m).to(self.device),
            )
        )
        for i, (st, j) in enumerate(zip(states, live)):
            # per-slot finalize: a failure here stays this slot's alone
            try:
                idx = state_slot_index(st.n_series, st.n_factors, n_pad)
                mean_i = mean_t[i][idx].astype(st.dtype)
                if sqrt_engine:
                    # the slot submatrix of the factor IS the factor of
                    # the slot submatrix (padding decouples exactly); the
                    # covariance is reconstituted for consumers, the
                    # factor persists and carries forward
                    chol_i = fac_t[i][np.ix_(idx, idx)].astype(st.dtype)
                    cov_i = chol_i @ chol_i.T
                else:
                    chol_i = None
                    cov_i = fac_t[i][np.ix_(idx, idx)].astype(st.dtype)
                # a degraded filter step books detf = +inf: the rows
                # were NOT assimilated, so the slot must not commit
                if np.all(np.isfinite(detf_t[i])) and np.all(
                    np.isfinite(sigma_t[i])
                ):
                    fault = posterior_fault(mean_i, cov_i, chol=chol_i)
                else:
                    fault = (
                        "non-finite likelihood step (degraded filter "
                        "update; observation not assimilated)"
                    )
                if fault is not None:
                    self._count("poisoned_updates")
                    logger.error("rejecting update for model %r: %s",
                                 st.model_id, fault)
                    results[j] = StateIntegrityError(
                        f"update for model {st.model_id!r} produced an "
                        f"invalid posterior ({fault}); the request was "
                        "not applied and the stored state is unchanged"
                    )
                    continue
                # chol_i is None on the joint engine, which also drops any
                # stale factor a square-root state carried
                new_state = st._replace(
                    version=st.version + 1, t_seen=st.t_seen + k,
                    mean=mean_i, cov=cov_i, chol=chol_i,
                )
                try:
                    self.registry.put(new_state,
                                      persist=self.persist_updates)
                except Exception:
                    # memory is written before disk: the update IS
                    # applied, only its write-through failed
                    self._count("persist_failures")
                    logger.exception(
                        "write-through persist failed for model %r "
                        "(serving from memory)", st.model_id,
                    )
                if not m[i].any():
                    self._count("empty_updates")
            except Exception as exc:
                self._count("finalize_failures")
                logger.exception("finalize failed for model %r; its update "
                                 "was not applied", st.model_id)
                results[j] = exc
                continue
            results[j] = new_state
        return results


__all__ = ["Forecast", "MetranService"]
