"""Batched L-BFGS in lane layout: the fleet optimizer.

Port of ``metran_tpu/parallel/lanes_lbfgs.py``: an L-BFGS for fleets of
small independent problems (one DFM likelihood per lane), every tensor
``(P, B)`` with the fleet axis last, every optimizer op elementwise over
lanes, on the device that holds the state.

- Each iteration has a fixed structure: a two-loop recursion unrolled
  over the history ring buffer and a *grid* line search — K candidate
  steps evaluated in ONE objective call over K*B lanes (one K3 launch
  on the card), then a per-lane select of the largest step that
  satisfies the Armijo condition.
- Each lane accepts its own step, keeps its own history validity
  (curvature guard ``s.y > 0``) and freezes on its own convergence; a
  lane's trajectory never depends on what else shares the batch.

Objective functions take the optimization variables first and the
problem data as trailing arguments: ``vg_fn(theta (P, B), *data) ->
((B,), (P, B))`` and ``obj_fn(cand (K, P, B), *data) -> (K, B)``, the
latter evaluating a stack of trial points in one call (the JAX package
``vmap``\\ s a single-point objective instead).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LanesLbfgsState(NamedTuple):
    """Optimizer carry, fleet axis LAST on every leaf.

    ``s_hist``/``y_hist`` are (m, P, B) ring buffers of parameter /
    gradient differences; ``rho`` is (m, B) with zeros marking empty or
    curvature-rejected slots (a zero ``rho`` makes the corresponding
    two-loop terms exact no-ops).
    """

    theta: torch.Tensor  # (P, B)
    value: torch.Tensor  # (B,)
    grad: torch.Tensor  # (P, B)
    s_hist: torch.Tensor  # (m, P, B)
    y_hist: torch.Tensor  # (m, P, B)
    rho: torch.Tensor  # (m, B)
    gamma: torch.Tensor  # (B,) initial-Hessian scale
    tstep: torch.Tensor  # (B,) per-lane trust scale for the step grid
    count: torch.Tensor  # (B,) int32 iterations taken
    nfev: torch.Tensor  # (B,) int32 objective evaluations
    stall: torch.Tensor  # (B,) int32 consecutive sub-stall_tol iterations
    frozen: torch.Tensor  # (B,) bool — lane takes no further steps


ARMIJO_C1 = 1e-4
TSTEP_GROW = 3.0  # expand the trust scale past an accepted step
TSTEP_MAX = 16.0
TSTEP_MIN = 1e-8
# cap on per-iteration movement in theta (= log-alpha) space: 4 units is
# a ~55x change in alpha, ample for any productive step, while blocking a
# single-step jump into the flat soft-cap region
MAX_DTHETA = 4.0
STALL_ITERS = 2  # consecutive sub-stall_tol iterations before freezing


def init_state(vg_fn, theta, history: int, *data) -> LanesLbfgsState:
    """Evaluate the objective once and build an empty-history state.

    The initial inverse-Hessian scale is ``1/max(|g|, 1)`` per lane, so
    the first trial step has unit length in theta space.
    """
    p, b = theta.shape
    value, grad = vg_fn(theta, *data)
    new = dict(dtype=theta.dtype, device=theta.device)
    zeros_h = torch.zeros((history, p, b), **new)
    gnorm = torch.linalg.vector_norm(grad, dim=0)
    ints = dict(dtype=torch.int32, device=theta.device)
    return LanesLbfgsState(
        theta=theta,
        value=value,
        grad=grad,
        s_hist=zeros_h,
        y_hist=zeros_h,
        rho=torch.zeros((history, b), **new),
        gamma=1.0 / torch.maximum(gnorm, torch.ones_like(gnorm)),
        tstep=torch.ones(b, **new),
        count=torch.zeros(b, **ints),
        nfev=torch.ones(b, **ints),
        stall=torch.zeros(b, **ints),
        frozen=torch.zeros(b, dtype=torch.bool, device=theta.device),
    )


def _direction(state: LanesLbfgsState) -> torch.Tensor:
    """Two-loop recursion, unrolled over the ring buffer (newest last).

    Empty/rejected history slots have ``rho == 0``, which zeroes their
    contributions exactly: one straight-line program for every fill
    level.
    """
    m = state.s_hist.shape[0]
    q = state.grad
    alphas = [None] * m
    for i in range(m - 1, -1, -1):  # newest slot is m-1
        a = state.rho[i] * torch.sum(state.s_hist[i] * q, dim=0)  # (B,)
        q = q - a * state.y_hist[i]
        alphas[i] = a
    r = state.gamma * q
    for i in range(m):
        b = state.rho[i] * torch.sum(state.y_hist[i] * r, dim=0)
        r = r + state.s_hist[i] * (alphas[i] - b)
    return -r


def make_step(vg_fn, obj_fn, ls_steps: Tuple[float, ...], maxiter: int,
              tol: float, stall_tol=None, stall_rtol: float = 0.0):
    """One fixed-structure L-BFGS iteration over ``(state, *data)``.

    ``ls_steps`` are the descending trial step multipliers of the grid
    line search.  ``stall_tol``/``stall_rtol``: a lane whose objective
    improves by at most ``stall_tol + stall_rtol * max(|value|, 1)`` for
    ``STALL_ITERS`` consecutive iterations freezes (either part alone
    arms it).
    """
    n_trials = len(ls_steps)

    def step(state: LanesLbfgsState, *data) -> LanesLbfgsState:
        # the grid follows the carry dtype: no constant promotes f32
        steps = torch.tensor(ls_steps, dtype=state.theta.dtype,
                             device=state.theta.device)
        d = _direction(state)
        # descent safeguard: a non-descent two-loop direction falls back
        # to scaled steepest descent, drops the history (rho = 0) and
        # restarts the trust scale
        gtd = torch.sum(state.grad * d, dim=0)  # (B,) directional slope
        bad_dir = gtd >= 0
        d = torch.where(bad_dir, -state.gamma * state.grad, d)
        gtd = torch.where(
            bad_dir, -state.gamma * torch.sum(state.grad**2, dim=0), gtd)
        rho_cur = torch.where(bad_dir, 0.0, state.rho)
        tstep_cur = torch.where(bad_dir, 1.0, state.tstep)
        # per-lane trial steps: trust scale x descending grid, clamped so
        # no trial moves theta more than MAX_DTHETA; one objective call
        # evaluates every lane at every trial
        d_norm = torch.linalg.vector_norm(d, dim=0)  # (B,)
        step_cap = MAX_DTHETA / torch.maximum(d_norm,
                                              torch.full_like(d_norm, 1e-30))
        trial = torch.minimum(tstep_cur[None] * steps[:, None],
                              step_cap[None])  # (K, B)
        cand = state.theta[None] + trial[:, None, :] * d[None]
        fvals = obj_fn(cand, *data)  # (K, B)
        armijo = fvals <= state.value[None] + ARMIJO_C1 * trial * gtd[None]
        # largest (first: steps descend) trial satisfying Armijo; if none
        # does, the best plain decrease
        first_ok = torch.argmax(armijo.to(torch.int32), dim=0)
        best = torch.argmin(fvals, dim=0)
        idx = torch.where(armijo.any(dim=0), first_ok, best)
        f_new = torch.gather(fvals, 0, idx[None])[0]
        improved = f_new < state.value
        accepted = torch.gather(trial, 0, idx[None])[0]
        alpha_step = torch.where(improved, accepted, 0.0)  # (B,)
        theta_new = state.theta + alpha_step * d
        value_new = torch.where(improved, f_new, state.value)
        # trust scale: grow past an accepted step, collapse below the
        # smallest trial when every candidate failed
        tstep = torch.where(
            improved,
            torch.clamp(TSTEP_GROW * accepted, max=TSTEP_MAX),
            torch.clamp(tstep_cur * steps[-1], min=TSTEP_MIN),
        )

        v_new, g_new = vg_fn(theta_new, *data)
        # a non-finite excursion keeps the previous iterate and gradient
        bad = ~torch.isfinite(v_new)
        theta_new = torch.where(bad, state.theta, theta_new)
        value_new = torch.where(bad, state.value, value_new)
        g_new = torch.where(bad, state.grad, g_new)

        s = theta_new - state.theta  # (P, B)
        yv = g_new - state.grad
        sy = torch.sum(s * yv, dim=0)  # (B,)
        yy = torch.sum(yv * yv, dim=0)
        # curvature guard: only lanes with s.y > 0 push a history pair
        valid = (sy > 1e-10) & improved & ~bad
        rho_new = torch.where(valid, 1.0 / torch.where(valid, sy, 1.0), 0.0)
        s_hist = torch.cat(
            [state.s_hist[1:], torch.where(valid, s, 0.0)[None]], dim=0)
        y_hist = torch.cat(
            [state.y_hist[1:], torch.where(valid, yv, 0.0)[None]], dim=0)
        rho = torch.cat([rho_cur[1:], rho_new[None]], dim=0)
        gamma = torch.where(valid, sy / torch.where(yy > 0, yy, 1.0),
                            state.gamma)

        frz = state.frozen

        def sel(a, b):
            return torch.where(frz, a, b)

        count = state.count + (~frz).to(torch.int32)
        if stall_tol is None and not stall_rtol:
            stall = state.stall
            stalled = torch.zeros_like(state.frozen)
        else:
            # <= so a zero threshold still freezes zero-improvement lanes;
            # the relative part tracks the CURRENT value (scipy's factr
            # criterion, with its max(|f|, 1) floor)
            thresh = (stall_tol or 0.0) + stall_rtol * torch.clamp(
                torch.abs(state.value), min=1.0)
            small = (state.value - value_new) <= thresh
            stall = torch.where(small, state.stall + 1, 0)
            stalled = stall >= STALL_ITERS
        nfev_step = torch.where(frz, 0, n_trials + 1).to(torch.int32)
        return LanesLbfgsState(
            theta=sel(state.theta, theta_new),
            value=sel(state.value, value_new),
            grad=sel(state.grad, g_new),
            s_hist=sel(state.s_hist, s_hist),
            y_hist=sel(state.y_hist, y_hist),
            rho=sel(state.rho, rho),
            gamma=sel(state.gamma, gamma),
            tstep=sel(state.tstep, tstep),
            count=count,
            nfev=state.nfev + nfev_step,
            stall=sel(state.stall, stall),
            frozen=frz
            | (torch.linalg.vector_norm(g_new, dim=0) < tol)
            | (count >= maxiter)
            | stalled,
        )

    return step


def make_chunk_runner(vg_fn, obj_fn, ls_steps, maxiter, tol, chunk,
                      stall_tol=None, stall_rtol=0.0):
    """A fixed-length chunk of iterations (no early exit inside).

    Frozen lanes ride along unchanged; the caller inspects
    ``count``/``value``/``frozen`` between chunks.
    """
    step = make_step(vg_fn, obj_fn, ls_steps, maxiter, tol, stall_tol,
                     stall_rtol)

    def run_chunk(state: LanesLbfgsState, *data) -> LanesLbfgsState:
        for _ in range(chunk):
            state = step(state, *data)
        return state

    return run_chunk


def default_ls_steps(n: int) -> Tuple[float, ...]:
    """Descending geometric step grid: 1, 0.3, 0.09, ... (n trials)."""
    return tuple(0.3 ** i for i in range(max(n, 1)))
