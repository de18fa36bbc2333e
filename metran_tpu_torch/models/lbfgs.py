"""L-BFGS with the zoom line search, batched over lanes of independent
problems.

A copy of optax 0.2.6's ``optax.lbfgs`` (``_src/alias.py``: the chain
``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``,
``scale(-1)``, ``scale_by_zoom_linesearch``; ``_src/transform.py::
scale_by_lbfgs``; ``_src/linesearch.py::zoom_linesearch`` and
``scale_by_zoom_linesearch``) and of ``optax.value_and_grad_from_state``,
which the JAX package drives through ``lbfgs_advance``.  The algorithm is
optax's, constants, approximate-Wolfe criterion and failure fallbacks
included; only the layout differs.  The card's host has no optax, and
the port imports none.

Layout: every tensor of the state leads with the lane axis B (``theta``
(B, P)); each lane runs optax's per-lane state machine.  Where the JAX
package ``vmap``\\ s a per-lane scalar objective, here the objective is
called once per line-search round on the lanes that still search:

    value_and_grad(theta (B', P), lanes (B',) long) -> (values (B',),
                                                       grads (B', P))

``lanes`` are the indices of the rows in the full batch, so the caller
can select their data; on the card one call is one filter launch and one
adjoint launch for all of them (a kernel cannot sit under a ``vmap``).
**Contract**: row ``i`` of the result must depend only on
``theta[i]`` and lane ``lanes[i]``'s data, never on which other lanes
share the call; then a lane's trajectory does not depend on its batch
mates.  Every operation of the optimizer itself is per lane.  Lanes that
are done (or ``maxiter`` 0, the fleet fit's frozen lanes) take no step.

Everything runs in the iterate's dtype (the JAX package traces the f32
optimizer with x64 disabled for the same reason, ``lbfgs_trace_ctx``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

#: optax.lbfgs's defaults
MEMORY_SIZE = 10
#: scale_by_zoom_linesearch's defaults
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5  # the zoom's interval threshold
LS_TOL = 0.0

ValueAndGrad = Callable[[torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor]]


class LbfgsState(NamedTuple):
    """optax's ``(ScaleByLBFGSState, ScaleByZoomLinesearchState)`` per
    lane: ``count`` (B,) int32, ``params``/``updates`` (B, P) (the last
    iterate and gradient), the memory ``diff_params``/``diff_updates``
    (B, m, P) and ``weights`` (B, m), then the line search's
    ``learning_rate``, ``value`` (B,), ``grad`` (B, P) and its info
    (``num_linesearch_steps`` (B,) int32, ``decrease_error``,
    ``curvature_error`` (B,))."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor
    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    num_linesearch_steps: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


class Lbfgs(NamedTuple):
    """The optimizer's configuration: ``optax.lbfgs(linesearch=
    scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy="one"))`` (optax's own defaults: memory
    MEMORY_SIZE, 20 line-search steps)."""

    max_linesearch_steps: int = 20

    def init(self, theta: torch.Tensor) -> "LbfgsState":
        return init(theta)


def init(theta: torch.Tensor) -> LbfgsState:
    """optax ``lbfgs().init`` for every lane of ``theta`` (B, P)."""
    b, p = theta.shape
    new = dict(dtype=theta.dtype, device=theta.device)
    ints = dict(dtype=torch.int32, device=theta.device)
    mem = torch.zeros((b, MEMORY_SIZE, p), **new)
    return LbfgsState(
        count=torch.zeros(b, **ints), params=torch.zeros_like(theta),
        updates=torch.zeros_like(theta), diff_params=mem,
        diff_updates=mem.clone(),
        weights=torch.zeros((b, MEMORY_SIZE), **new),
        learning_rate=torch.ones(b, **new),
        value=torch.full((b,), float("inf"), **new),
        grad=torch.zeros_like(theta),
        num_linesearch_steps=torch.zeros(b, **ints),
        decrease_error=torch.full((b,), float("inf"), **new),
        curvature_error=torch.full((b,), float("inf"), **new))


def value_and_grad_rows(fn, theta: torch.Tensor, *args):
    """``(fn(theta, *args), d sum(fn) / d theta)`` by torch autograd,
    detached: for a ``fn`` whose value rows are separable in the rows of
    ``theta``, every row's value and gradient from one backward pass."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        value = fn(th, *args)
        (grad,) = torch.autograd.grad(value.sum(), th)
    return value.detach(), grad


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product of (B, P) tensors."""
    return torch.sum(a * b, dim=-1)


def _where(cond, a, b):
    """``where`` of per-lane ``cond`` (B,) over (B, ...) tensors."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _evaluate(value_and_grad: ValueAndGrad, theta, active):
    """``value_and_grad`` at the active rows of ``theta``; the other rows
    of the returned full-size tensors are NaN (never selected)."""
    idx = torch.nonzero(active).flatten()
    value = torch.full(theta.shape[:1], float("nan"), dtype=theta.dtype,
                       device=theta.device)
    grad = torch.full_like(theta, float("nan"))
    if idx.numel():
        v, g = value_and_grad(theta.index_select(0, idx), idx)
        value = value.index_copy(0, idx, v.to(theta.dtype))
        grad = grad.index_copy(0, idx, g.to(theta.dtype))
    return value, grad


# ----------------------------------------------------------------------
# scale_by_lbfgs
# ----------------------------------------------------------------------
def lbfgs_direction(grad, theta, state: LbfgsState):
    """optax ``scale_by_lbfgs().update`` then ``scale(-1)``: the
    direction ``-P_k g`` and the updated memory (fields of
    :class:`LbfgsState`)."""
    count = state.count
    m = state.weights.shape[1]
    memory_idx = count.long() % m
    prev_idx = (count.long() - 1) % m
    diff_params = theta - state.params
    diff_updates = grad - state.updates
    vd = vdot(diff_updates, diff_params)
    weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    started = count > 0
    diff_params = _where(started, diff_params, torch.zeros_like(diff_params))
    diff_updates = _where(started, diff_updates,
                          torch.zeros_like(diff_updates))
    weight = torch.where(started, weight, torch.zeros_like(weight))
    rows = torch.arange(count.shape[0], device=count.device)
    dp_mem = state.diff_params.clone()
    du_mem = state.diff_updates.clone()
    w_mem = state.weights.clone()
    dp_mem[rows, prev_idx] = diff_params
    du_mem[rows, prev_idx] = diff_updates
    w_mem[rows, prev_idx] = weight
    # scale_init_precond
    numerator = vdot(diff_updates, diff_params)
    denominator = vdot(diff_updates, diff_updates)
    identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                 torch.ones_like(numerator))
    update_norm = torch.sqrt(vdot(grad, grad))
    capped_inv_norm = torch.minimum(torch.ones_like(update_norm),
                                    1.0 / update_norm)
    identity_scale = torch.where(started, identity_scale, capped_inv_norm)
    # _precondition_by_lbfgs: the two-loop recursion, newest slot first
    order = [(memory_idx + j) % m for j in range(m)]
    vec = grad
    alphas = [None] * m
    for j in range(m - 1, -1, -1):
        idx = order[j]
        dwi, dui = dp_mem[rows, idx], du_mem[rows, idx]
        alpha = w_mem[rows, idx] * vdot(dwi, vec)
        vec = vec + (-alpha)[:, None] * dui
        alphas[j] = alpha
    vec = identity_scale[:, None] * vec
    for j in range(m):
        idx = order[j]
        dwi, dui = dp_mem[rows, idx], du_mem[rows, idx]
        beta = w_mem[rows, idx] * vdot(dui, vec)
        vec = vec + (alphas[j] - beta)[:, None] * dwi
    return -1.0 * vec, dict(
        count=count + 1, params=theta, updates=grad, diff_params=dp_mem,
        diff_updates=du_mem, weights=w_mem)


# ----------------------------------------------------------------------
# zoom_linesearch
# ----------------------------------------------------------------------
class _Zoom(NamedTuple):
    """optax's ``ZoomLinesearchState`` per lane (scalars (B,), vectors
    (B, P)); ``params``/``updates`` ride beside it."""

    count: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax ``_cubicmin`` (from scipy): a critical point of the cubic
    through (a, fa), (b, fb), (c, fc) with slope fpa at a (NaN when the
    radical is negative)."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - cc * db
    v1 = fc - fa - cc * dc
    big_a = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    big_b = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = big_b * big_b - 3.0 * big_a * cc
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """optax ``_quadmin``: a critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    big_b = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * big_b)


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    """Sufficient-decrease error with the approximate-Wolfe switch
    (Hager-Zhang); NaN maps to +inf."""
    err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = (value_step - value_init
                    - APPROX_DEC_RTOL * torch.abs(value_init))
    approx = torch.maximum(approx, delta_values)
    err = torch.minimum(approx, err)
    err = torch.maximum(err, torch.zeros_like(err))
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _curvature_error(slope_step, slope_init):
    err = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    err = torch.maximum(err, torch.zeros_like(err))
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _zoom_init(value, grad, updates) -> _Zoom:
    """optax ``zoom_linesearch``'s ``init_fn`` with
    ``initial_guess_strategy="one"``."""
    slope = vdot(updates, grad)
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, float("inf"))
    false = torch.zeros_like(value, dtype=torch.bool)
    return _Zoom(
        count=torch.zeros_like(value, dtype=torch.int32), stepsize=zero,
        value=value, grad=grad, slope=slope, value_init=value,
        slope_init=slope, decrease_error=inf, curvature_error=inf,
        error=inf, interval_found=false, done=false, failed=false, low=zero,
        value_low=value, slope_low=slope, high=zero, value_high=value,
        slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
        safe_stepsize=zero, safe_value=value, safe_grad=grad)


def _search_trial(st: _Zoom):
    """The stepsize ``_search_interval`` tries."""
    return torch.where(st.count == 0, torch.ones_like(st.stepsize),
                       INCREASE_FACTOR * st.stepsize)


def _zoom_trial(st: _Zoom):
    """The stepsize ``_zoom_into_interval`` tries: cubic, else
    quadratic, else bisection."""
    low, high = st.low, st.high
    delta = torch.abs(high - low)
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    middle_cubic = _cubicmin(low, st.value_low, st.slope_low, high,
                             st.value_high, st.cubic_ref,
                             st.value_cubic_ref)
    use_cubic = ((middle_cubic > left + cubic_chk)
                 & (middle_cubic < right - cubic_chk))
    middle_quad = _quadmin(low, st.value_low, st.slope_low, high,
                           st.value_high)
    use_quad = (~use_cubic & (middle_quad > left + quad_chk)
                & (middle_quad < right - quad_chk))
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, middle_cubic, st.cubic_ref)
    middle = torch.where(use_quad, middle_quad, middle)
    return torch.where(use_bisection, (low + high) / 2.0, middle)


def _search_interval(st: _Zoom, stepsize, value, grad, slope,
                     max_steps: int) -> _Zoom:
    """optax ``_search_interval`` given the trial's evaluation."""
    dec = _decrease_error(stepsize, value, slope, st.value_init,
                          st.slope_init)
    curv = _curvature_error(slope, st.slope_init)
    error = torch.maximum(dec, curv)
    safe_decrease = dec <= LS_TOL
    safe_stepsize = torch.where(safe_decrease, stepsize, st.safe_stepsize)
    safe_value = torch.where(safe_decrease, value, st.safe_value)
    safe_grad = _where(safe_decrease, grad, st.safe_grad)
    set_high = (dec > 0.0) | ((value >= st.value) & (st.count > 0))
    set_low = (slope >= 0.0) & ~set_high
    low = torch.where(set_low, stepsize, st.stepsize)
    value_low = torch.where(set_low, value, st.value)
    slope_low = torch.where(set_low, slope, st.slope)
    high = torch.where(set_low, st.stepsize, stepsize)
    value_high = torch.where(set_low, st.value, value)
    slope_high = torch.where(set_low, st.slope, slope)
    done = error <= LS_TOL
    return st._replace(
        count=st.count + 1, stepsize=stepsize, value=value, grad=grad,
        slope=slope, decrease_error=dec, curvature_error=curv, error=error,
        interval_found=set_high | set_low | done, done=done,
        failed=(st.count + 1 >= max_steps) & ~done, low=low,
        value_low=value_low, slope_low=slope_low, high=high,
        value_high=value_high, slope_high=slope_high, cubic_ref=low,
        value_cubic_ref=value_low, safe_stepsize=safe_stepsize,
        safe_value=safe_value, safe_grad=safe_grad)


def _zoom_into_interval(st: _Zoom, middle, value, grad, slope,
                        max_steps: int) -> _Zoom:
    """optax ``_zoom_into_interval`` given the trial's evaluation."""
    too_small_int = torch.abs(st.high - st.low) <= STEPSIZE_PRECISION
    dec = _decrease_error(middle, value, slope, st.value_init,
                          st.slope_init)
    curv = _curvature_error(slope, st.slope_init)
    error = torch.maximum(dec, curv)
    update_safe = (dec <= LS_TOL) & (value < st.safe_value)
    safe_stepsize = torch.where(update_safe, middle, st.safe_stepsize)
    safe_value = torch.where(update_safe, value, st.safe_value)
    safe_grad = _where(update_safe, grad, st.safe_grad)
    done = error <= LS_TOL
    set_high_mid = (dec > 0.0) | (value >= st.value_low)
    set_high_low = ((slope * (st.high - st.low) >= 0.0) & ~set_high_mid)
    set_low_mid = ~set_high_mid
    high = torch.where(set_high_mid, middle, st.high)
    value_high = torch.where(set_high_mid, value, st.value_high)
    slope_high = torch.where(set_high_mid, slope, st.slope_high)
    high = torch.where(set_high_low, st.low, high)
    value_high = torch.where(set_high_low, st.value_low, value_high)
    slope_high = torch.where(set_high_low, st.slope_low, slope_high)
    low = torch.where(set_low_mid, middle, st.low)
    value_low = torch.where(set_low_mid, value, st.value_low)
    slope_low = torch.where(set_low_mid, slope, st.slope_low)
    moved_high = set_high_mid | set_high_low
    cubic_ref = torch.where(moved_high, st.high, st.low)
    value_cubic_ref = torch.where(moved_high, st.value_high, st.value_low)
    presumably_failed = ((st.count + 1 >= max_steps)
                         | (too_small_int & (safe_stepsize > 0.0)))
    return st._replace(
        count=st.count + 1, stepsize=middle, value=value, grad=grad,
        slope=slope, decrease_error=dec, curvature_error=curv, error=error,
        done=done, failed=presumably_failed & ~done, low=low,
        value_low=value_low, slope_low=slope_low, high=high,
        value_high=value_high, slope_high=slope_high, cubic_ref=cubic_ref,
        value_cubic_ref=value_cubic_ref, safe_stepsize=safe_stepsize,
        safe_value=safe_value, safe_grad=safe_grad)


def _try_safe_step(st: _Zoom) -> _Zoom:
    """optax ``_try_safe_step``: fall back to the best step with a
    sufficient decrease (or to no step when every trial left the
    domain)."""
    use_safe = (st.safe_stepsize > 0.0) | torch.isinf(st.decrease_error)
    return st._replace(
        stepsize=torch.where(use_safe, st.safe_stepsize, st.stepsize),
        value=torch.where(use_safe, st.safe_value, st.value),
        grad=_where(use_safe, st.safe_grad, st.grad))


def _select(cond, new: _Zoom, old: _Zoom) -> _Zoom:
    return _Zoom(*(_where(cond, a, b) for a, b in zip(new, old)))


def zoom_search(value_and_grad: ValueAndGrad, theta, updates, value,
                grad, active, max_linesearch_steps: int) -> _Zoom:
    """optax's zoom line search along ``updates`` from ``theta`` for the
    ``active`` lanes (B,) bool: one batched objective call per round, on
    the lanes still searching.  Returns the final per-lane state."""
    st = _zoom_init(value, grad, updates)
    searching = active.clone()
    while bool(searching.any()):
        trial = torch.where(st.interval_found, _zoom_trial(st),
                            _search_trial(st))
        v, g = _evaluate(value_and_grad, theta + trial[:, None] * updates,
                         searching)
        s = vdot(g, updates)
        new = _select(st.interval_found,
                      _zoom_into_interval(st, trial, v, g, s,
                                          max_linesearch_steps),
                      _search_interval(st, trial, v, g, s,
                                       max_linesearch_steps))
        new = _select(new.failed, _try_safe_step(new), new)
        st = _select(searching, new, st)
        searching = searching & ~(st.done | st.failed)
    return st


# ----------------------------------------------------------------------
# lbfgs_advance
# ----------------------------------------------------------------------
def value_and_grad_from_state(value_and_grad: ValueAndGrad, theta,
                              state: LbfgsState, active):
    """optax ``value_and_grad_from_state``: the value and gradient the
    last line search left in ``state``, re-evaluated (one batched call)
    on the ``active`` lanes whose stored value is not finite."""
    stale = active & ~torch.isfinite(state.value)
    value, grad = state.value, state.grad
    if bool(stale.any()):
        v, g = _evaluate(value_and_grad, theta, stale)
        value = torch.where(stale, v, value)
        grad = _where(stale, g, grad)
    return value, grad


def step(value_and_grad: ValueAndGrad, theta, state: LbfgsState, active,
         max_linesearch_steps: int):
    """One optax L-BFGS iteration (``value_and_grad_from_state``, the
    update, ``apply_updates``) on the ``active`` lanes; the others keep
    their ``(theta, state)``."""
    value, grad = value_and_grad_from_state(value_and_grad, theta, state,
                                            active)
    direction, memory = lbfgs_direction(grad, theta, state)
    ls = zoom_search(value_and_grad, theta, direction, value, grad, active,
                     max_linesearch_steps)
    new_theta = theta + ls.stepsize[:, None] * direction
    new = state._replace(
        **memory, learning_rate=ls.stepsize, value=ls.value, grad=ls.grad,
        num_linesearch_steps=ls.count, decrease_error=ls.decrease_error,
        curvature_error=ls.curvature_error)
    new = LbfgsState(*(_where(active, a, b) for a, b in zip(new, state)))
    return _where(active, new_theta, theta), new


def grad_norm(state: LbfgsState) -> torch.Tensor:
    """(B,) l2 norm of the stored gradient (optax ``tree_norm``)."""
    return torch.sqrt(vdot(state.grad, state.grad))


def lbfgs_advance(value_and_grad: ValueAndGrad, theta, state: LbfgsState,
                  tol: float, maxiter, max_new_iters: int, nfev=None,
                  max_linesearch_steps: int = 20):
    """Advance every lane's L-BFGS by up to ``max_new_iters`` iterations
    (the JAX package's ``lbfgs_advance``, batched): a lane iterates while
    ``(count == 0 or |grad| >= tol) and count < maxiter`` and it has
    taken fewer than ``max_new_iters`` iterations in this call.
    ``maxiter`` is an int or a (B,) tensor (0 freezes a lane).  Returns
    ``(theta, state, nfev)``; ``nfev`` (B,) int32 counts objective
    evaluations (the first iteration's, then one per line-search step).
    """
    b = theta.shape[0]
    ints = dict(dtype=torch.int32, device=theta.device)
    nfev = (torch.zeros(b, **ints) if nfev is None
            else torch.as_tensor(nfev, **ints).expand(b).clone())
    maxiter = torch.as_tensor(maxiter, **ints).expand(b)
    count0 = state.count
    while True:
        count = state.count
        active = (((count == 0) | (grad_norm(state) >= tol))
                  & (count < maxiter) & (count - count0 < max_new_iters))
        if not bool(active.any()):
            return theta, state, nfev
        first = active & (count == 0)
        theta, state = step(value_and_grad, theta, state, active,
                            max_linesearch_steps)
        nfev = (nfev + first.to(torch.int32)
                + torch.where(active, state.num_linesearch_steps,
                              torch.zeros_like(nfev)))


__all__ = [
    "Lbfgs",
    "LbfgsState",
    "MEMORY_SIZE",
    "grad_norm",
    "init",
    "lbfgs_advance",
    "lbfgs_direction",
    "step",
    "value_and_grad_from_state",
    "value_and_grad_rows",
    "vdot",
    "zoom_search",
]
