"""The port's L-BFGS with the zoom line search
(``metran_tpu_torch.models.lbfgs``, a copy of optax 0.2.6's ``lbfgs``,
``scale_by_zoom_linesearch`` and ``value_and_grad_from_state``) against
optax itself, f64 on the CPU.

Tolerances: the iterates at each of the first 20 iterations within 1e-10
(relative to ``max(1, |theta|)``) of optax's, with ``count`` and
``num_linesearch_steps`` identical — the two sides differ only in the
order of their inner products' sums; a lane's trajectory in a batch
identical, bit for bit, to the same lane run alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

from metran_tpu_torch.models import lbfgs

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)

ITERS = 20
A_DIAG = np.logspace(0, 4, 6)  # an ill-conditioned quadratic (1e4)


def rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosen_torch(x):
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1.0 - x[:, :-1]) ** 2, dim=-1)


def quad_jax(x):
    return 0.5 * jnp.sum(jnp.asarray(A_DIAG) * x * x) + jnp.sum(x)


def quad_torch(x):
    return 0.5 * torch.sum(torch.as_tensor(A_DIAG) * x * x, dim=-1) \
        + x.sum(-1)


PROBLEMS = {
    "rosenbrock": (rosen_jax, rosen_torch, np.array([-1.2, 1.0, -0.5, 0.3])),
    "ill_conditioned_quadratic": (quad_jax, quad_torch, np.ones(6)),
}


def value_and_grad(f):
    """The batched objective of a batched torch function."""

    def vg(theta, lanes):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            v = f(th)
            (g,) = torch.autograd.grad(v.sum(), th)
        return v.detach(), g

    return vg


def optax_run(f, x0, iters, max_ls, **kw):
    """``iters`` optax L-BFGS iterations as the JAX package drives them
    (``value_and_grad_from_state``, then ``update`` and
    ``apply_updates``): the iterate, count, line-search steps and value
    after each.  ``kw`` are ``f``'s keyword arguments."""
    opt = optax.lbfgs(linesearch=optax.scale_by_zoom_linesearch(
        max_linesearch_steps=max_ls, initial_guess_strategy="one"))
    vg = optax.value_and_grad_from_state(f)

    @jax.jit
    def iterate(theta, state, kw):
        value, grad = vg(theta, state=state, **kw)
        updates, state = opt.update(grad, state, theta, value=value,
                                    grad=grad, value_fn=f, **kw)
        return optax.apply_updates(theta, updates), state

    theta = jnp.asarray(x0)
    state = opt.init(theta)
    out = []
    for _ in range(iters):
        theta, state = iterate(theta, state, kw)
        out.append((np.asarray(theta), int(otu.tree_get(state, "count")),
                    int(otu.tree_get(state, "info").num_linesearch_steps),
                    float(otu.tree_get(state, "value")),
                    float(np.linalg.norm(np.asarray(
                        otu.tree_get(state, "grad"))))))
    return out


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_iterates_match_optax(name):
    f_jax, f_torch, x0 = PROBLEMS[name]
    want = optax_run(f_jax, x0, ITERS, 16)
    theta = torch.tensor(x0)[None]
    state = lbfgs.init(theta)
    vg = value_and_grad(f_torch)
    active = torch.ones(1, dtype=torch.bool)
    for it, (w_theta, w_count, w_ls, w_value, _) in enumerate(want):
        theta, state = lbfgs.step(vg, theta, state, active, 16)
        got = theta[0].numpy()
        scale = max(1.0, np.max(np.abs(w_theta)))
        assert np.max(np.abs(got - w_theta)) / scale < 1e-10, (name, it)
        assert int(state.count[0]) == w_count, (name, it)
        assert int(state.num_linesearch_steps[0]) == w_ls, (name, it)
        assert float(state.value[0]) == pytest.approx(w_value, rel=1e-10,
                                                      abs=1e-12)


def _scaled_quadratics(scales):
    """Lanes of quadratics ``0.5 s_b x'Ax + 1'x`` that converge at
    different iterations under a gradient tolerance."""
    s = torch.as_tensor(np.asarray(scales, float))

    def f(theta, lanes):
        return 0.5 * s[lanes] * torch.sum(
            torch.as_tensor(A_DIAG[:3]) * theta * theta, dim=-1) \
            + theta.sum(-1)

    def vg(theta, lanes):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            v = f(th, lanes)
            (g,) = torch.autograd.grad(v.sum(), th)
        return v.detach(), g

    return vg


def test_lanes_stop_at_different_iterations_as_optax_does():
    """A batch whose lanes meet the gradient tolerance at different
    iterations: each lane's count and iterate equal optax's run of that
    lane alone, stopped by the JAX package's ``lbfgs_advance`` rule."""
    scales = [1.0, 30.0, 0.05, 400.0]
    tol = 1e-6
    b = len(scales)
    x0 = np.tile(np.array([1.0, -2.0, 0.5]), (b, 1))
    theta = torch.tensor(x0)
    theta, state, nfev = lbfgs.lbfgs_advance(
        _scaled_quadratics(scales), theta, lbfgs.init(theta), tol, 60, 60,
        max_linesearch_steps=16)
    counts = state.count.tolist()
    assert len(set(counts)) > 1, counts

    def f(x, sc):
        return 0.5 * sc * jnp.sum(jnp.asarray(A_DIAG[:3]) * x * x) \
            + jnp.sum(x)

    for i, sc in enumerate(scales):
        run = optax_run(f, x0[i], max(counts) + 1, 16, sc=jnp.asarray(sc))
        # lbfgs_advance's stop: the first iteration whose stored gradient
        # (the line search's last) is under tol
        stop = next(k for k, r in enumerate(run) if r[4] < tol)
        assert counts[i] == run[stop][1], (i, counts[i], run[stop][1])
        np.testing.assert_allclose(theta[i].numpy(), run[stop][0],
                                   rtol=1e-9, atol=1e-12)
        assert int(nfev[i]) == 1 + sum(r[2] for r in run[:stop + 1])


def test_a_lane_does_not_depend_on_its_batch_mates():
    """B = 1 against B = 4: lane 0's trajectory is bit-identical."""
    scales = [3.0, 1.0, 0.05, 400.0]
    x0 = np.array([[1.0, -2.0, 0.5], [0.3, 0.1, -4.0], [2.0, 2.0, 2.0],
                   [-1.0, 0.0, 1.0]])
    alone = torch.tensor(x0[:1])
    th1, st1, n1 = lbfgs.lbfgs_advance(
        _scaled_quadratics(scales[:1]), alone, lbfgs.init(alone), 1e-9, 25,
        25)
    batch = torch.tensor(x0)
    th4, st4, n4 = lbfgs.lbfgs_advance(
        _scaled_quadratics(scales), batch, lbfgs.init(batch), 1e-9, 25, 25)
    assert torch.equal(th1[0], th4[0])
    assert torch.equal(st1.value[0], st4.value[0])
    assert int(st1.count[0]) == int(st4.count[0]) and int(n1[0]) == int(n4[0])


def test_frozen_lanes_take_no_step():
    scales = [1.0, 2.0]
    x0 = torch.tensor([[1.0, -2.0, 0.5], [1.0, -2.0, 0.5]])
    th, st, nfev = lbfgs.lbfgs_advance(
        _scaled_quadratics(scales), x0, lbfgs.init(x0), 1e-9,
        torch.tensor([0, 30], dtype=torch.int32), 30)
    assert torch.equal(th[0], x0[0]) and int(st.count[0]) == 0
    assert int(nfev[0]) == 0 and int(st.count[1]) > 0


def test_jax_named_api_chunks_as_the_jax_package_does():
    """``solver.lbfgs_advance(objective, zoom_linesearch(k), ...)``
    advanced in two chunks against the JAX package's on Rosenbrock: the
    same iterate (1e-10), count and nfev after each chunk."""
    from metran_tpu.models import solver as jax_solver
    from metran_tpu_torch.models import solver

    f_jax, f_torch, x0 = PROBLEMS["rosenbrock"]
    j_opt = optax.lbfgs(linesearch=jax_solver.zoom_linesearch(16))
    j_theta = jnp.asarray(x0)
    j_state, j_nfev = j_opt.init(j_theta), 0
    opt = solver.zoom_linesearch(16)
    theta = torch.tensor(x0)[None]
    state, nfev = opt.init(theta), 0
    for _ in range(2):
        j_theta, j_state, j_nfev = jax_solver.lbfgs_advance(
            f_jax, j_opt, j_theta, j_state, 1e-9, 30, 4, j_nfev)
        theta, state, nfev = solver.lbfgs_advance(
            value_and_grad(f_torch), opt, theta, state, 1e-9, 30, 4, nfev)
        np.testing.assert_allclose(theta[0].numpy(), np.asarray(j_theta),
                                   rtol=1e-10, atol=1e-10)
        assert int(state.count[0]) == int(otu.tree_get(j_state, "count"))
        assert int(nfev[0]) == int(j_nfev)
