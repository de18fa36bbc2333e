"""Port parity: the robust (implicit-MAP) updates of
``metran_tpu_torch.ops`` — the plain versions of K12's and K9's robust
instantiations, on CPU tensors — against the JAX package's
``implicit_map_filter_append`` / ``implicit_map_sqrt_filter_append``,
f64 on the CPU: each likelihood on both engines, one model and a batch
(armed and disarmed models, masked slots, both rails, per-slot
parameters), and ``likelihood="gaussian"``.

Bars: posteriors and likelihood terms 1e-10 normwise (relative to each
array's largest entry; the two sides differ by matmul/QR roundoff and
by the elementary functions' last bits, which a flagged slot's Newton
iterates carry forward), z-scores 1e-12 and NaN-strict, verdicts and
iterations equal; square-root factors compared through ``S S'``.  The
sequential Student-t rows hold the port to JAX evaluated op by op (see
``_jax_one``), on one appended row.
"""

import jax
import numpy as np
import pytest
import torch

from metran_tpu import ops as jops
from metran_tpu_torch import ops as pops
from metran_tpu_torch.ops.statespace import StateSpace
from test_torch_implicit_map import BAR, LIKELIHOODS, _batch, _port_ss, _rel

torch.set_num_threads(1)


def _op_by_op(likelihood, engine):
    return likelihood == "huber_t" and engine == "sequential"


def _k_app(likelihood, engine):
    # the op-by-op reference is slow: fewer appended rows and models
    return 1 if _op_by_op(likelihood, engine) else 6


def _jax_one(fn, ss, carry, y, m, armed, par, likelihood):
    """The JAX function's result.  A Student-t solve that stops at its
    step cap carries every rounding forward, and there JAX's jitted
    executable (whose fused arithmetic rounds on its own) and the same
    function evaluated op by op differ by up to ~2e-10; the port follows
    the op-by-op evaluation (to ~1e-16 on these rows), so the Student-t
    rows are held to that one."""
    def run():
        return fn(ss, *carry, y, m, armed=armed, likelihood=likelihood,
                  nu=4.0, **par)

    sqrt = fn is jops.implicit_map_sqrt_filter_append
    if not _op_by_op(likelihood, "sqrt" if sqrt else "sequential"):
        return run()
    with jax.disable_jit():
        return run()


def _check(got, want, sqrt=False):
    assert _rel(got[0], want[0]) <= BAR
    if sqrt:
        w = np.asarray(want[1])
        assert _rel(got[1] @ got[1].transpose(-1, -2), w @ np.swapaxes(
            w, -1, -2)) <= BAR
    else:
        assert _rel(got[1], want[1]) <= BAR
    for g, w in zip(got[2:4], want[2:4]):
        assert _rel(g, w) <= BAR
    assert _rel(got[4], want[4]) <= 1e-12
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    assert got[5].dtype == torch.int8 and got[6].dtype == torch.int32


@pytest.mark.parametrize("engine", ["sequential", "sqrt"])
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_one_model_matches_jax(likelihood, engine):
    sqrt = engine == "sqrt"
    (ss, carry, scarry, y, m, _, par), = _batch(4, likelihood, 1,
                                                _k_app(likelihood, engine))
    jfn = (jops.implicit_map_sqrt_filter_append if sqrt
           else jops.implicit_map_filter_append)
    pfn = (pops.implicit_map_sqrt_filter_append if sqrt
           else pops.implicit_map_filter_append)
    c = scarry if sqrt else carry
    want = _jax_one(jfn, ss, c, y, m, True, par, likelihood)
    got = pfn(_port_ss(ss), *c, y, m, armed=True, likelihood=likelihood,
              nu=4.0, device="cpu", **par)
    _check(got, want, sqrt)
    assert (got[5] != 0).any()  # something took the MAP path


@pytest.mark.parametrize("engine", ["sequential", "sqrt"])
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_batch_with_armed_and_disarmed_models_matches_jax(likelihood,
                                                          engine):
    """Models in one call (leaves and carry leading with B, per-model
    arming and per-slot parameters), each held to its own JAX call; the
    last, disarmed, flags nothing."""
    sqrt = engine == "sqrt"
    few = _op_by_op(likelihood, engine)
    cases = _batch(5, likelihood, 2 if few else 3, _k_app(likelihood, engine))
    jfn = (jops.implicit_map_sqrt_filter_append if sqrt
           else jops.implicit_map_filter_append)
    pfn = (pops.implicit_map_sqrt_filter_append if sqrt
           else pops.implicit_map_filter_append)
    want = [_jax_one(jfn, ss, sc if sqrt else c, y, m, a, par, likelihood)
            for ss, c, sc, y, m, a, par in cases]
    ss_b = StateSpace(*(torch.as_tensor(np.stack([np.asarray(cs[0][i])
                                                  for cs in cases]))
                        for i in range(len(cases[0][0]))))
    carry = [np.stack([cs[2 if sqrt else 1][j] for cs in cases])
             for j in range(2)]
    params = {k: np.stack([cs[6][k] for cs in cases]) for k in cases[0][6]}
    got = pfn(ss_b, *carry, np.stack([cs[3] for cs in cases]),
              np.stack([cs[4] for cs in cases]),
              armed=np.array([cs[5] for cs in cases]),
              likelihood=likelihood, nu=4.0, device="cpu", **params)
    for b, w in enumerate(want):
        _check(tuple(g[b] for g in got), w, sqrt)
    assert not got[5][-1].any() and not got[6][-1].any()
    assert torch.isfinite(got[4][-1][torch.as_tensor(cases[-1][4])]).all()


@pytest.mark.parametrize("engine", ["sequential", "sqrt"])
def test_gaussian_likelihood_matches_jax(engine):
    sqrt = engine == "sqrt"
    (ss, carry, scarry, y, m, _, _), = _batch(6, "huber_t", 1)
    jfn = (jops.implicit_map_sqrt_filter_append if sqrt
           else jops.implicit_map_filter_append)
    pfn = (pops.implicit_map_sqrt_filter_append if sqrt
           else pops.implicit_map_filter_append)
    c = scarry if sqrt else carry
    want = jfn(ss, *c, y, m, likelihood="gaussian")
    got = pfn(_port_ss(ss), *c, y, m, likelihood="gaussian", device="cpu")
    _check(got, want, sqrt)
    assert torch.isnan(got[4]).all()


