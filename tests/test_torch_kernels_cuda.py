"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card every test skips (the CPU suite
holds the plain versions against JAX instead).  Run on a card with::

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which a GPU
host need not have; this file uses none of its fixtures.)

Bars: f64 normwise relative error 1e-9, f32 1e-3 (the kernels and the
plain versions order their sums differently).
"""

import numpy as np
import pytest
import torch

from metran_tpu_torch import kernels
from metran_tpu_torch.ops import dfm_statespace

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double(), want.double()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    scale = want[fin].abs().max().clamp_min(1e-300)
    return float((got[fin] - want[fin]).abs().max() / scale)


def _inputs(card, dtype, b=8, k=6, n=5, kf=2):
    rng = np.random.default_rng(0)
    ss = dfm_statespace(rng.uniform(5, 40, (b, n)), rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, n, kf)), 1.0, device=card,
                        dtype=dtype)
    s = n + kf
    y = torch.as_tensor(rng.normal(size=(b, k, n)), dtype=dtype, device=card)
    mask = torch.as_tensor(rng.uniform(size=(b, k, n)) > 0.3, device=card)
    mask[:, 1] = False
    mean = torch.zeros(b, s, dtype=dtype, device=card)
    cov = torch.eye(s, dtype=dtype, device=card).expand(b, s, s).contiguous()
    return (*ss, mean, cov, y, mask)


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_joint_filter_kernel_matches_plain(card, dtype, bar):
    args = _inputs(card, dtype)
    got = kernels.joint_filter_append(*args)
    want = kernels.joint_filter_append_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_forecast_kernel_matches_plain(card, dtype, bar):
    phi, q, z, r, mean, cov, _, _ = _inputs(card, dtype)
    hz = torch.arange(1, 31, device=card).to(dtype)
    got = kernels.forecast_moments(phi, q, z, r, mean, cov, hz)
    want = kernels.forecast_moments_plain(phi, q, z, r, mean, cov, hz)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar


def _lanes_inputs(card, dtype, b=6, t=70, n_obs=5, kf=1, trials=3):
    """A small lane fleet: ``trials`` trial lanes per data lane, a fully
    masked series, a fully masked step, a near-unit-root lane (every
    state at alpha = 3e4 in f64; in f32 the common factor only: with
    every state there, the innovation variances of these random panels
    fall to ~1e-5 of P and f32 itself disagrees with f64 by ~1e-2)."""
    from metran_tpu_torch.ops.lanes import lanes_statespace

    rng = np.random.default_rng(1)
    lanes = trials * b
    alpha = rng.uniform(2.0, 50.0, (n_obs + kf, lanes))
    alpha[-1 if dtype == torch.float32 else slice(None), 0] = 3e4
    ld = np.tile(rng.uniform(0.4, 0.8, (n_obs, kf, b)), (1, 1, trials))
    phi, q, z, r = lanes_statespace(
        *(torch.as_tensor(a, dtype=dtype, device=card)
          for a in (alpha, ld, np.ones(lanes))))
    y = torch.as_tensor(rng.normal(size=(b, t, n_obs)), dtype=dtype,
                        device=card)
    mask = torch.as_tensor(rng.uniform(size=(b, t, n_obs)) > 0.3, device=card)
    mask[:, :, -1] = False
    mask[:, 3] = False
    lane_map = torch.arange(b, dtype=torch.int32, device=card).repeat(trials)
    return phi, q, z, r, y, mask, lane_map


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_lanes_filter_and_adjoint_kernels_match_plain(card, dtype, bar):
    args = _lanes_inputs(card, dtype)
    got = kernels.lanes_filter(*args, seg=32, keep_bounds=True)
    want = kernels.lanes_filter_plain(*args, seg=32, keep_bounds=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar
    g = torch.Generator(device="cpu").manual_seed(2)
    sb = torch.randn(want.sigma.shape, generator=g).to(card, dtype)
    db = torch.randn(want.sigma.shape, generator=g).to(card, dtype)
    adj = (*args, 32, want.bounds_mean, want.bounds_cov, sb, db)
    got = kernels.lanes_adjoint(*adj)
    want = kernels.lanes_adjoint_plain(*adj)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert _rel(g_, w) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_lanes_smooth_kernel_matches_plain(card, dtype, bar):
    args = _lanes_inputs(card, dtype)
    fwd = kernels.lanes_filter(*args, seg=32, keep_bounds=True)
    for want_cov in (True, False):
        sm = (*args, 32, fwd.bounds_mean, fwd.bounds_cov, want_cov)
        got = kernels.lanes_smooth_bwd(*sm)
        want = kernels.lanes_smooth_bwd_plain(*sm)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _rel(g, w) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_lanes_forward_kernel_matches_plain(card, dtype, bar):
    args = _lanes_inputs(card, dtype)
    lanes = args[0].shape[1]
    t_last = torch.arange(lanes, dtype=torch.int32, device=card) * 5
    for mode in ("project", "innovations", "latch"):
        got = kernels.lanes_forward(*args[:6], mode, args[6], t_last)
        want = kernels.lanes_forward_plain(*args[:6], mode, args[6], t_last)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _rel(g, w) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_lanes_sample_kernel_matches_plain(card, dtype, bar):
    phi, q, z, r = _lanes_inputs(card, dtype)[:4]
    r = r.clone()
    r[:, ::2] = 0.1
    lanes, n, t = phi.shape[1], phi.shape[0], 70
    g = torch.Generator(device=card).manual_seed(3)
    normals = [torch.randn(shape, generator=g, device=card, dtype=dtype)
               for shape in ((lanes, n), (lanes, t, n),
                             (lanes, t, z.shape[0]))]
    got = kernels.lanes_sample(phi, q, z, r, *normals)
    want = kernels.lanes_sample_plain(phi, q, z, r, *normals)
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert _rel(g_, w) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_stored_filter_and_rts_smoother_kernels_match_plain(card, dtype,
                                                           bar):
    """K6 in its store mode, then K8 over the stored moments, against the
    plain versions; one lane with an indefinite predicted covariance at
    one step exercises K8's degrade rule."""
    from metran_tpu_torch.kernels import smoother as ksm

    args = _lanes_inputs(card, dtype)
    got = kernels.lanes_forward(*args[:6], "store", args[6])
    want = kernels.lanes_forward_plain(*args[:6], "store", args[6])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar
    mean_p, cov_p, mean_f, cov_f = (w.clone() for w in want[:4])
    cov_p[1, 30] -= 10.0 * torch.eye(cov_p.shape[-1], dtype=dtype,
                                     device=card)
    phi = args[0].T.contiguous()
    for want_cov in (True, False):
        sm = (phi, mean_f, cov_f, mean_p, cov_p)
        got = ksm.rts_smooth(*sm, want_cov=want_cov)
        ref = ksm.rts_smooth_plain(*sm, want_cov=want_cov)
        torch.cuda.synchronize()
        assert _rel(got[0], ref[0]) <= bar
        if want_cov:
            assert _rel(got[1], ref[1]) <= bar
        else:
            assert got[1] is None
        # the degraded step is the filtered one
        assert torch.equal(got[0][1, 29], mean_f[1, 29])


def _outer(chol):
    return chol @ chol.transpose(-1, -2)


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_sqrt_filter_kernel_matches_plain(card, dtype, bar):
    """K9 in its store and carry-only instantiations, from (0, I) and
    from a given (non-triangular) carry, against the plain version;
    lane 1 is fully masked and lane 2 has an observed slot with r < 0
    (detf = +inf, the state passed through).  Filtered factors are held
    through the covariance they stand for (rank-deficient under r = 0)."""
    phi, q, z, r, y, mask, lane_map = _lanes_inputs(card, dtype)
    mask = mask.clone()
    mask[1] = False
    r = r.clone()
    r[0, 2] = -1.0
    mask[2, 4, 0] = True
    args = (phi, q, z, r, y, mask, lane_map)
    got = kernels.sqrt_filter(*args, store=True)
    want = kernels.sqrt_filter_plain(*args, store=True)
    torch.cuda.synchronize()
    for i in (0, 1, 2, 4, 5):
        assert _rel(got[i], want[i]) <= bar
    assert _rel(_outer(got[3]), _outer(want[3])) <= bar
    assert torch.isinf(got[5][2, 4]) and got[4][2, 4] == 0
    assert torch.equal(got[5][1], torch.zeros_like(got[5][1]))
    carry = kernels.sqrt_filter(*args)
    assert _rel(carry[0], got[2][:, -1]) <= bar
    assert _rel(_outer(carry[1]), _outer(got[3][:, -1])) <= bar
    n = phi.shape[0]
    rot = torch.linalg.qr(torch.randn(phi.shape[1], n, n, dtype=dtype,
                                      device=card)).Q
    m0 = want[2][:, 20].contiguous()
    c0 = (want[3][:, 20] @ rot).contiguous()
    got = kernels.sqrt_filter(*args, mean0=m0, chol0=c0)
    ref = kernels.sqrt_filter_plain(*args, mean0=m0, chol0=c0)
    torch.cuda.synchronize()
    for i in (0, 2, 3):
        assert _rel(got[i], ref[i]) <= bar
    assert _rel(_outer(got[1]), _outer(ref[1])) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_sqrt_smoother_kernel_matches_plain(card, dtype, bar):
    """K10 in its covariance and mean-only modes over K9's plain store,
    against the plain version."""
    phi, q, z, r, y, mask, lane_map = _lanes_inputs(card, dtype)
    st = kernels.sqrt_filter_plain(phi, q, z, r, y, mask, lane_map,
                                   store=True)
    sm = (phi.T.contiguous(), q.T.contiguous(), st[2], st[3], st[0], st[1])
    for want_cov in (True, False):
        got = kernels.sqrt_smooth(*sm, want_cov=want_cov)
        ref = kernels.sqrt_smooth_plain(*sm, want_cov=want_cov)
        torch.cuda.synchronize()
        assert _rel(got[0], ref[0]) <= bar
        if want_cov:
            assert _rel(_outer(got[1]), _outer(ref[1])) <= bar
        else:
            assert got[1] is None


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_bounds_modes_are_the_carry_modes_bit_for_bit(card, dtype, bar):
    """K1 and K9 with segment boundaries: the terms and the final carry
    equal the carry-only instantiation's exactly; the boundaries equal
    the plain versions'.  Observation noise keeps the 40 steps'
    covariances well conditioned (with r = 0 and two factors they go
    singular, and two factorizations of them disagree)."""
    phi, q, z, r, mean, cov, y, mask = _inputs(card, dtype, k=40)
    r = torch.full_like(r, 0.2)
    carry = kernels.joint_filter_append(phi, q, z, r, mean, cov, y, mask)
    bnd = kernels.joint_filter_append(phi, q, z, r, mean, cov, y, mask,
                                      bounds_seg=16)
    plain = kernels.joint_filter_append_plain(phi, q, z, r, mean, cov, y,
                                              mask, bounds_seg=16)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(carry, bnd[:4]))
    for g, w in zip(bnd[4:], plain[4:]):
        assert _rel(g, w) <= bar
    lanes = (phi.T.contiguous(), torch.diagonal(q, 0, -2, -1).T.contiguous(),
             z.permute(1, 2, 0).contiguous(), r.T.contiguous(), y, mask)
    carry = kernels.sqrt_filter(*lanes)
    bnd = kernels.sqrt_filter(*lanes, bounds_seg=16)
    plain = kernels.sqrt_filter_plain(*lanes, bounds_seg=16)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(carry, bnd[:4]))
    assert _rel(bnd[4], plain[4]) <= bar
    assert _rel(bnd[5] @ bnd[5].transpose(-1, -2),
                plain[5] @ plain[5].transpose(-1, -2)) <= bar


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_joint_adjoint_kernel_matches_plain(card, dtype, bar, factored):
    """K11 over covariance (K1) or factor (K9) boundaries, with an r < 0
    slot on one model (degraded steps) and an all-masked step."""
    phi, q, z, r, mean, cov, y, mask = _inputs(card, dtype, k=40)
    r = torch.full_like(r, 0.2)
    r[0, 2] = -5.0
    qd = torch.diagonal(q, 0, -2, -1).contiguous()
    if factored:
        out = kernels.sqrt_filter(phi.T.contiguous(), qd.T.contiguous(),
                                  z.permute(1, 2, 0).contiguous(),
                                  r.T.contiguous(), y, mask, bounds_seg=16)
    else:
        out = kernels.joint_filter_append(phi, q, z, r, mean, cov, y, mask,
                                          bounds_seg=16)
    g = torch.Generator(device=card).manual_seed(3)
    sb = torch.rand(y.shape[:2], generator=g, device=card, dtype=dtype)
    db = torch.rand(y.shape[:2], generator=g, device=card, dtype=dtype)
    kernels.reset_launches()
    got = kernels.joint_adjoint(phi, qd, z, r, y, mask, out[4], out[5], sb,
                                db, 16, factored)
    want = kernels.joint_adjoint_plain(phi, qd, z, r, y, mask, out[4],
                                       out[5], sb, db, 16, factored)
    torch.cuda.synchronize()
    assert kernels.launches()["joint_adjoint"] == 1
    for gt, wt in zip(got, want):
        assert _rel(gt, wt) <= bar


def _k11_ring_case(card, dtype, b, t, seg, n_obs=5, kf=2, factored=False,
                   degraded=False, masked_seg=False):
    """K11's inputs over K1 (or, ``factored``, K9) boundaries: ``b``
    models of ``n_obs`` series and ``kf`` factors over ``t`` steps, an
    all-masked step, optionally a fully masked segment (the second) and
    degraded steps mid-segment (model 0's slot 2 has r < 0 and is
    observed at a few steps in the middle of the first segment only)."""
    rng = np.random.default_rng(7)
    ss = dfm_statespace(rng.uniform(5, 40, (b, n_obs)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, n_obs, kf)) / kf, 1.0,
                        device=card, dtype=dtype)
    phi, q, z, r = ss
    r = torch.full_like(r, 0.2)
    mask = rng.uniform(size=(b, t, n_obs)) > 0.3
    if t > 3:
        mask[:, 3] = False
    if masked_seg:
        mask[:, seg:2 * seg] = False
    if degraded:
        r[0, 2] = -5.0
        mask[0, :, 2] = False
        mid = np.arange(seg // 3, min(t, 2 * seg // 3), 3)
        mask[0, mid, 2] = True
    y = torch.as_tensor(np.where(mask, rng.normal(size=mask.shape), 0.0),
                        dtype=dtype, device=card)
    mask = torch.as_tensor(mask, device=card)
    qd = torch.diagonal(q, 0, -2, -1).contiguous()
    s = phi.shape[1]
    if factored:
        out = kernels.sqrt_filter(phi.T.contiguous(), qd.T.contiguous(),
                                  z.permute(1, 2, 0).contiguous(),
                                  r.T.contiguous(), y, mask, bounds_seg=seg)
    else:
        mean = torch.zeros(b, s, dtype=dtype, device=card)
        cov = torch.eye(s, dtype=dtype, device=card).expand(b, s, s)
        out = kernels.joint_filter_append(phi, q, z, r, mean, cov.contiguous(),
                                          y, mask, bounds_seg=seg)
    g = torch.Generator(device=card).manual_seed(3)
    sb = torch.rand(y.shape[:2], generator=g, device=card, dtype=dtype)
    db = torch.rand(y.shape[:2], generator=g, device=card, dtype=dtype)
    return (phi, qd, z, r, y, mask, out[4], out[5], sb, db, seg, factored)


SEG = 16
_RING = 4  # the ring depth of the (5, 7) models below (ring_depth's)
K11_CASES = {
    "B1-T1": dict(b=1, t=1),
    "B3-T=seg-1": dict(b=3, t=SEG - 1),
    "B3-T=seg": dict(b=3, t=SEG),
    "B133-ring-wraps": dict(b=133, t=_RING * SEG + 5),
    # the ring wrapping in the wide block (few models): its groups refill
    "B3-ring-wraps": dict(b=3, t=_RING * SEG + 5),
    "B3-ring-wraps-factored": dict(b=3, t=_RING * SEG + 5, factored=True),
    "masked-segment": dict(b=3, t=3 * SEG + 2, masked_seg=True),
    "degraded-mid-segment": dict(b=3, t=2 * SEG + 7, degraded=True),
    "factored-degraded": dict(b=3, t=2 * SEG + 7, degraded=True,
                              factored=True),
    "N40-n41": dict(b=3, t=2 * SEG + 5, n_obs=40, kf=1),
    "N45-n46-spill": dict(b=2, t=2 * SEG + 5, n_obs=45, kf=1),
    # more models than the card keeps resident in the wide block: the
    # compact one, on the same wide and spilled shapes
    "B133-N40-n41": dict(b=133, t=2 * SEG + 5, n_obs=40, kf=1),
    "B133-N45-n46-spill": dict(b=133, t=SEG + 3, n_obs=45, kf=1),
    # seg >= T on a long series: one replay of 6,000 steps that the sweep
    # waits for in full
    "seg=T-long-replay": dict(b=1, t=6000, seg=6000),
    "seg>T-long-replay": dict(b=1, t=6000, seg=8192),
}


@pytest.mark.parametrize("case", sorted(K11_CASES))
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_joint_adjoint_ring_cases(card, dtype, bar, case):
    """The warp-specialised K11 (ring of replayed segments, replay groups
    beside the sweep warps) against its plain version, NaN-strict, one
    launch per call: short and exact-multiple horizons, a ring that wraps,
    a fully masked segment, degraded steps mid-segment, factor boundaries,
    several rows of F per lane (N = 40) and the device-memory layout, in
    the wide block (few models) and the compact one (B = 133); one long
    segment (seg >= T)."""
    import importlib

    ja = importlib.import_module("metran_tpu_torch.kernels.joint_adjoint")
    args = _k11_ring_case(card, dtype, **{"seg": SEG, **K11_CASES[case]})
    if "ring-wraps" in case:
        b = K11_CASES[case]["b"]
        assert ja.ring_depth(5, 7, dtype, -(-args[4].shape[1] // SEG)) \
            == (_RING, False)
        assert ja.block_shape(b, 5, 7, dtype, _RING, False, card) == (
            ja.COMPACT if b > 132 else ja.WIDE)
    if case == "N45-n46-spill" and dtype == torch.float64:
        assert ja.ring_depth(45, 46, dtype, 3)[1]
    kernels.reset_launches()
    got = kernels.joint_adjoint(*args)
    want = kernels.joint_adjoint_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launches()["joint_adjoint"] == 1
    for gt, wt in zip(got, want):
        assert torch.equal(torch.isnan(gt), torch.isnan(wt))
        assert _rel(gt, wt) <= bar


def _gate_inputs(card, dtype, k=6):
    """K12's inputs with spikes on known cells and an armed mix (the
    loadings keep every communality below 1, so Q is PSD)."""
    b, n, kf = 8, 5, 2
    rng = np.random.default_rng(4)
    ss = dfm_statespace(rng.uniform(5, 40, (b, n)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, n, kf)) / np.sqrt(kf), 1.0,
                        device=card, dtype=dtype)
    s = n + kf
    y = torch.as_tensor(rng.normal(size=(b, k, n)), dtype=dtype, device=card)
    mask = torch.as_tensor(rng.uniform(size=(b, k, n)) > 0.3, device=card)
    mask[:, 1] = False
    mean = torch.zeros(b, s, dtype=dtype, device=card)
    cov = torch.eye(s, dtype=dtype, device=card).expand(b, s, s).contiguous()
    phi, q, z, r = ss
    for b, t, i, size in ((0, 0, 2, 30.0), (2, 3, 0, -25.0), (5, 2, 4, 40.0)):
        y[b, t, i] += size
        mask[b, t, i] = True
    armed = torch.tensor([True, True, False, True, True, True, False, True],
                         device=card)
    return (phi, q, z, r, mean, cov, y, mask), armed


def _nan_rel(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    return _rel(got, want) if torch.isfinite(want).any() else 0.0


@pytest.mark.parametrize("policy", ["off", "reject", "huber", "inflate"])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_gated_filter_kernel_matches_plain(card, dtype, bar, policy):
    """K12 in each policy against its plain version (NaN-strict, equal
    verdicts); an armed gate that never trips (nsigma = inf) is the
    ``off`` instantiation bit for bit."""
    args, armed = _gate_inputs(card, dtype)
    got = kernels.gated_filter_append(*args, armed, policy, 4.0)
    want = kernels.gated_filter_append_plain(*args, armed, policy, 4.0)
    torch.cuda.synchronize()
    for g, w in zip(got[:5], want[:5]):
        assert _nan_rel(g, w) <= bar
    assert torch.equal(got[5], want[5])
    if policy != "off":
        assert got[5][0, 0, 2] != 0 and got[5][2].eq(0).all()
    off = kernels.gated_filter_append(*args, armed, "off", 0.0)
    never = kernels.gated_filter_append(*args, armed, policy, float("inf"))
    torch.cuda.synchronize()
    for g, w in zip(never[:4], off[:4]):
        assert torch.equal(g, w)
    assert not never[5].any()


def _lanes_of(args):
    phi, q, z, r, mean, cov, y, mask = args
    return (phi.T.contiguous(), torch.diagonal(q, 0, -2, -1).T.contiguous(),
            z.permute(1, 2, 0).contiguous(), r.T.contiguous(), y, mask)


@pytest.mark.parametrize("policy", ["reject", "huber", "inflate"])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_gated_sqrt_filter_kernel_matches_plain(card, dtype, bar, policy):
    """K9's gated instantiation against its plain version from a given
    non-triangular carry (factors through S S'); a run where nothing
    trips is K9's given-carry instantiation bit for bit."""
    args, armed = _gate_inputs(card, dtype)
    lanes = _lanes_of(args)
    b, s = args[4].shape
    m0 = torch.randn(b, s, dtype=dtype, device=card) * 0.1
    c0 = torch.linalg.qr(torch.randn(b, s, s, dtype=dtype,
                                     device=card)).Q * 0.7
    got = kernels.sqrt_filter_gated(*lanes, m0, c0, armed, policy, 4.0)
    want = kernels.sqrt_filter_gated_plain(*lanes, m0, c0, armed, policy,
                                           4.0)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= bar
    assert _rel(_outer(got[1]), _outer(want[1])) <= bar
    for g, w in zip(got[2:5], want[2:5]):
        assert _nan_rel(g, w) <= bar
    assert torch.equal(got[5], want[5])
    assert got[5].any()
    base = kernels.sqrt_filter(*lanes, mean0=m0, chol0=c0)
    never = kernels.sqrt_filter_gated(*lanes, m0, c0, armed, policy,
                                      float("inf"))
    torch.cuda.synchronize()
    for g, w in zip(never[:4], base):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_detect_kernel_matches_plain(card, dtype, bar):
    """K13 against its plain version: a drifting, autocorrelated stream
    with NaN z-scores, masked steps and a disarmed model; equal counts."""
    g = torch.Generator(device=card).manual_seed(5)
    b, k, n = 6, 200, 7
    zs = torch.randn((b, k, n), generator=g, device=card, dtype=dtype)
    zs[:, 100:, 0] += 2.5  # a level shift
    zs[:, 1:, 1] = 0.2 * zs[:, 1:, 1] + 0.98 * zs[:, :-1, 1]  # drift
    zs[:, ::17, 2] = float("nan")
    mask = torch.rand((b, k, n), generator=g, device=card) > 0.1
    armed = torch.tensor([True] * 5 + [False], device=card)
    state = torch.zeros((b, 6, n), dtype=dtype, device=card)
    args = (state, zs, mask, armed)
    kw = dict(cusum_k=0.5, cusum_h=8.0, lb_window=32, lb_thresh=9.0,
              nsigma=2.5)
    got = kernels.detect_scan(*args, **kw)
    want = kernels.detect_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= bar
    assert torch.equal(got[1], want[1])
    assert got[1][:5].sum(dim=(0, 2)).gt(0).all()  # every kind alarmed
    assert torch.equal(got[0][5], state[5]) and not got[1][5].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_joint_store_mode_is_the_carry_mode_bit_for_bit(card, dtype):
    """K1's store: the terms equal the carry instantiation's, every
    stored filtered step is K1's one-step carry from the step before,
    and the moments match the plain store."""
    phi, q, z, r, mean, cov, y, mask = _inputs(card, dtype, k=40)
    r = torch.full_like(r, 0.2)
    args = (phi, q, z, r, mean, cov, y, mask)
    carry = kernels.joint_filter_append(*args)
    st = kernels.joint_filter_store(*args)
    plain = kernels.joint_filter_store_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(st[2][:, -1], carry[0])
    assert torch.equal(st[3][:, -1], carry[1])
    assert torch.equal(st[4], carry[2]) and torch.equal(st[5], carry[3])
    bar = 1e-9 if dtype == torch.float64 else 1e-3
    for g, w in zip(st, plain):
        assert _rel(g, w) <= bar
    b, k, s = st[2].shape
    rep = lambda t: t[:, None].expand(b, k - 1, *t.shape[1:]).reshape(
        b * (k - 1), *t.shape[1:]).contiguous()
    one = kernels.joint_filter_append(
        rep(phi), rep(q), rep(z), rep(r),
        st[2][:, :-1].reshape(-1, s).contiguous(),
        st[3][:, :-1].reshape(-1, s, s).contiguous(),
        y[:, 1:].reshape(-1, 1, y.shape[-1]).contiguous(),
        mask[:, 1:].reshape(-1, 1, mask.shape[-1]).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(one[0], st[2][:, 1:].reshape(-1, s))
    assert torch.equal(one[1], st[3][:, 1:].reshape(-1, s, s))


def _robust_case(card, dtype, likelihood, k=6, warm=40):
    """K12's gate inputs (an armed mix) from the posterior after ``warm``
    steps of the same kind of data, as the likelihood's sensor reports
    them: both rails (censored, about a fifth of the readings beyond
    each), a grid of 0.25 (quantized) or spikes on known cells (huber_t,
    at a likelihood scale of 0.5, where every solve converges: at 0.05
    most hit the step cap, and a capped solve is not reproducible to the
    roundoff); per-slot parameters (B, N)."""
    args, armed = _gate_inputs(card, dtype, warm + k)
    phi, q, z, r, mean, cov, y, mask = args
    mean, cov = kernels.joint_filter_append(
        phi, q, z, r, mean, cov, y[:, :warm].contiguous(),
        mask[:, :warm].contiguous())[:2]
    y, mask = y[:, warm:].clone(), mask[:, warm:].clone()
    if likelihood == "huber_t":
        for b, t, i, size in ((0, 0, 2, 30.0), (2, 3, 0, -25.0),
                              (5, 2, 4, 40.0)):
            y[b, t, i] += size
            mask[b, t, i] = True
    b, n = y.shape[0], y.shape[2]
    full = dict(dtype=dtype, device=card)
    lo = torch.full((b, n), -float("inf"), **full)
    hi = torch.full((b, n), float("inf"), **full)
    quantum = torch.ones((b, n), **full)
    if likelihood == "censored":
        obs = y[mask]
        lo[:], hi[:] = obs.quantile(0.2), obs.quantile(0.8)
        y = torch.minimum(torch.maximum(y, lo[:, None]), hi[:, None])
    elif likelihood == "quantized":
        quantum[:] = 0.25
        y = 0.25 * torch.round(y / 0.25)
    scale = torch.full((b, n), 0.5 if likelihood == "huber_t" else 0.1,
                       **full)
    return ((phi, q, z, r, mean, cov, y.contiguous(), mask.contiguous()),
            armed, (lo, hi, quantum, scale))


def _robust_equal(got, want, dtype):
    """Verdicts and iterations: equal in f64; in f32 the MAP/NONCONV
    split and the steps (+-1) may differ on a few flagged slots."""
    assert torch.equal(got[5] != 0, want[5] != 0)  # the flagged sets
    if dtype == torch.float64:
        assert torch.equal(got[5], want[5]) and torch.equal(got[6], want[6])
    else:
        flagged = int((want[5] != 0).sum())
        off = int((got[5] != want[5]).sum()) + int(
            ((got[6] - want[6]).abs() > 1).sum())
        assert off <= max(1, 0.005 * flagged)


@pytest.mark.parametrize("likelihood", ["censored", "quantized", "huber_t"])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_robust_filter_kernel_matches_plain(card, dtype, bar, likelihood):
    """K12's robust instantiation against its plain version (NaN-strict;
    verdicts and iterations as ``_robust_equal``), counted under its own
    name; disarmed, and (censored) with rails nothing reaches, it is the
    ``off`` instantiation bit for bit."""
    args, armed, par = _robust_case(card, dtype, likelihood)
    kernels.reset_launches()
    got = kernels.robust_filter_append(*args, armed, *par,
                                       likelihood=likelihood)
    torch.cuda.synchronize()
    assert kernels.launches()["gated_filter_robust"] == 1
    assert kernels.launches()["gated_filter"] == 0
    want = kernels.robust_filter_append_plain(*args, armed, *par,
                                              likelihood=likelihood)
    for g, w in zip(got[:5], want[:5]):
        assert _nan_rel(g, w) <= bar
    _robust_equal(got, want, dtype)
    assert got[5].any() and not got[5][2].any()  # model 2 is disarmed
    off = kernels.gated_filter_append(*args, armed, "off", 0.0)
    lo, hi, quantum, scale = par
    nothing = [kernels.robust_filter_append(
        *args, torch.zeros_like(armed), *par, likelihood=likelihood)]
    if likelihood == "censored":
        nothing.append(kernels.robust_filter_append(
            *args, armed, lo - 1e6, hi + 1e6, quantum, scale))
    torch.cuda.synchronize()
    for out in nothing:
        for g, w in zip(out[:4], off[:4]):
            assert torch.equal(g, w)
        assert not out[5].any() and not out[6].any()


@pytest.mark.parametrize("likelihood", ["censored", "quantized", "huber_t"])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_sqrt_robust_kernel_matches_plain(card, dtype, bar, likelihood):
    """K9's robust instantiation against its plain version from a given
    non-triangular carry (factors through S S'), counted under its own
    name; disarmed, and (censored) with rails nothing reaches, it is K9's
    given-carry instantiation bit for bit."""
    args, armed, par = _robust_case(card, dtype, likelihood)
    lanes = _lanes_of(args)
    b, s = args[4].shape
    m0 = torch.randn(b, s, dtype=dtype, device=card) * 0.1
    c0 = torch.linalg.qr(torch.randn(b, s, s, dtype=dtype,
                                     device=card)).Q * 0.7
    kernels.reset_launches()
    got = kernels.sqrt_filter_robust(*lanes, m0, c0, armed, *par,
                                     likelihood=likelihood)
    torch.cuda.synchronize()
    assert kernels.launches()["sqrt_filter_robust"] == 1
    assert kernels.launches()["sqrt_filter_gated"] == 0
    want = kernels.sqrt_filter_robust_plain(*lanes, m0, c0, armed, *par,
                                            likelihood=likelihood)
    assert _rel(got[0], want[0]) <= bar
    assert _rel(_outer(got[1]), _outer(want[1])) <= bar
    for g, w in zip(got[2:5], want[2:5]):
        assert _nan_rel(g, w) <= bar
    _robust_equal(got, want, dtype)
    assert got[5].any() and not got[5][2].any()
    base = kernels.sqrt_filter(*lanes, mean0=m0, chol0=c0)
    lo, hi, quantum, scale = par
    nothing = [kernels.sqrt_filter_robust(
        *lanes, m0, c0, torch.zeros_like(armed), *par,
        likelihood=likelihood)]
    if likelihood == "censored":
        nothing.append(kernels.sqrt_filter_robust(
            *lanes, m0, c0, armed, lo - 1e6, hi + 1e6, quantum, scale))
    torch.cuda.synchronize()
    for out in nothing:
        for g, w in zip(out[:4], base):
            assert torch.equal(g, w)
        assert not out[5].any() and not out[6].any()


def _dfm(card, dtype, b=8, n=5, kf=2):
    """Valid DFMs (communalities below 1, as the fits make them)."""
    rng = np.random.default_rng(4)
    return dfm_statespace(rng.uniform(5, 40, (b, n)),
                          rng.uniform(10, 60, (b, kf)),
                          rng.uniform(0.3, 0.8, (b, n, kf)) / np.sqrt(kf),
                          1.0, device=card, dtype=dtype)


def _steady_case(card, dtype, b=8, k=5, n=5, kf=2):
    """Models with their frozen gains (K15's own plain version), a mean,
    rows with spikes and one masked cell, and an armed mix."""
    phi, q, z, r = _dfm(card, dtype, b, n, kf)
    gains = kernels.dare_gains_plain(phi, q, z, r)
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.normal(size=(b, k, n)) * 0.5, dtype=dtype,
                        device=card)
    y[0, 1, 2] += 30.0
    y[3, 2, 0] -= 30.0
    mask = torch.ones((b, k, n), dtype=torch.bool, device=card)
    mask[5, 3, 1] = False
    real = torch.ones((b, n), dtype=torch.bool, device=card)
    mean = torch.as_tensor(rng.normal(size=(b, n + kf)) * 0.3, dtype=dtype,
                           device=card)
    armed = torch.tensor([i % 4 != 3 for i in range(b)], device=card)
    return phi, z, gains, real, mean, y, mask, armed


STEADY_FORMS = [(p, False) for p in ("off", "reject", "huber", "inflate")] \
    + [(p, True) for p in ("reject", "huber", "inflate")]


@pytest.mark.parametrize("policy,seq", STEADY_FORMS)
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_steady_filter_kernel_matches_plain(card, dtype, bar, policy, seq):
    """K14 in every policy and form against its plain version: means and
    terms normwise, broke, verdicts and the NaN pattern equal."""
    phi, z, g, real, mean, y, mask, armed = _steady_case(card, dtype)
    kg, fd = (g[4], g[5]) if seq else (g[2], g[3])
    kernels.reset_launches()
    got = kernels.steady_filter(phi, z, kg, fd, real, mean, y, mask, armed,
                                policy, 16.0, seq)
    torch.cuda.synchronize()
    assert kernels.launches()["steady_filter"] == 1
    want = kernels.steady_filter_plain(phi, z, kg, fd, real, mean, y, mask,
                                       armed, policy, 16.0, seq)
    for i in (0, 1, 2, 4):
        assert _nan_rel(got[i], want[i]) <= bar
    assert torch.equal(got[3], want[3]) and torch.equal(got[5], want[5])
    assert bool(got[3][5])  # the masked cell
    if policy != "off":
        assert bool(got[5][0].any())


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_dare_kernel_matches_plain(card, dtype, bar):
    """K15 against its plain version in every output, solving and from
    a given p_pred; the f64 fixed point solves the DARE to 1e-10."""
    phi, q, z, r = _dfm(card, dtype)
    kernels.reset_launches()
    got = kernels.dare_gains(phi, q, z, r)
    torch.cuda.synchronize()
    assert kernels.launches()["dare"] == 1
    want = kernels.dare_gains_plain(phi, q, z, r)
    for g, w in zip(got, want):
        assert torch.isfinite(w).all() and _rel(g, w) <= bar
    given = kernels.dare_gains(phi, q, z, r, p_pred=want[0])
    for g, w in zip(given[1:], kernels.dare_gains_plain(phi, q, z, r,
                                                        p_pred=want[0])[1:]):
        assert _rel(g, w) <= bar
    if dtype == torch.float64:
        p = got[0]
        f = z @ p @ z.transpose(-1, -2) + torch.diag_embed(r)
        pz = p @ z.transpose(-1, -2)
        res = (p - phi[:, :, None] * (p - pz @ torch.linalg.solve(
            f, pz.transpose(-1, -2))) * phi[:, None, :] - q)
        assert float(res.abs().max() / p.abs().max()) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sqrt_store_from_a_carry_matches_plain_and_continues(card, dtype):
    """K9 ``store`` from a given carry (the fixed-lag window) against its
    plain version, and bit for bit the full run's last steps."""
    args = _inputs(card, dtype, k=12)
    lanes = _lanes_of(args)
    full = kernels.sqrt_filter(*lanes, store=True)
    cut = 7
    rest = [t[:, cut:].contiguous() for t in lanes[4:]]
    m0 = full[2][:, cut - 1].contiguous()
    c0 = full[3][:, cut - 1].contiguous()
    got = kernels.sqrt_filter(*lanes[:4], *rest, store=True, mean0=m0,
                              chol0=c0)
    want = kernels.sqrt_filter_plain(*lanes[:4], *rest, store=True,
                                     mean0=m0, chol0=c0)
    torch.cuda.synchronize()
    bar = 1e-9 if dtype == torch.float64 else 1e-3
    for i in (0, 2, 4, 5):
        assert _nan_rel(got[i], want[i]) <= bar
    for i in (1, 3):
        assert _rel(_outer(got[i]), _outer(want[i])) <= bar
    for g, f in zip(got, full):
        assert torch.equal(g, f[:, cut:])


# ----------------------------------------------------------------------
# K16, K17, K18: the state arena's in-place kernels
# ----------------------------------------------------------------------
ARENA_MODES = [("joint", "off", None), ("gated", "off", None),
               ("gated", "reject", None), ("gated", "huber", None),
               ("gated", "off", "censored"), ("sqrt", "off", None),
               ("sqrt", "inflate", None), ("sqrt", "off", "quantized")]
DET_PARAMS = dict(cusum_k=0.5, cusum_h=3.0, lb_window=8, lb_thresh=2.0,
                  nsigma=2.0)


ARENA_LEAVES = ("mean", "fac", "t_seen", "version", "phi", "q", "z", "r",
                "steady", "kgain", "fdiag", "det")


def leaves_of(arena):
    """An unsharded ``StateArena``'s leaves by name, in the order of its
    ``_dynamic``, ``_static``, ``_steady_leaves`` and ``_det_leaf``."""
    import types

    return types.SimpleNamespace(**dict(zip(ARENA_LEAVES, (
        *arena._dynamic(), *arena._static(), *arena._steady_leaves(),
        arena._det_leaf()))))


def k17_leaves(arena):
    """The leaves K17 takes ahead of the steady ones: mean, t_seen,
    version, phi and z."""
    a = leaves_of(arena)
    return a.mean, a.t_seen, a.version, a.phi, a.z


def _arena(card, dtype, sqrt, b=12, n=5, kf=2, n_pad=8, s_pad=16):
    """Arena leaves of ``b`` rows packed from random fitted-looking
    models (padded to the bucket), a NaN row 2 and, on a covariance
    arena, a non-PSD row 4; ``t_seen`` straddles the floors."""
    from metran_tpu_torch.serve.state import StateArena

    rng = np.random.default_rng(3)
    arena = StateArena((n_pad, s_pad), b, dtype=dtype, sqrt=sqrt,
                       device=card)
    a = rng.normal(size=(b + 1, s_pad, s_pad))
    cov = a @ a.transpose(0, 2, 1) / s_pad + 0.1 * np.eye(s_pad)
    fac = np.linalg.cholesky(cov) if sqrt else cov
    leaves = leaves_of(arena)
    leaves.fac.copy_(torch.as_tensor(fac, dtype=dtype))
    leaves.mean.copy_(torch.as_tensor(rng.normal(size=(b + 1, s_pad)),
                                      dtype=dtype))
    leaves.t_seen.copy_(torch.as_tensor(rng.integers(0, 60, b + 1),
                                        dtype=torch.int32))
    ss = dfm_statespace(rng.uniform(5, 40, (b + 1, n_pad)),
                        rng.uniform(10, 60, (b + 1, s_pad - n_pad)),
                        rng.uniform(0.1, 0.5, (b + 1, n_pad, s_pad - n_pad)),
                        1.0, device=card, dtype=dtype)
    for leaf, val in zip(arena._static(), ss):
        leaf.copy_(val)
    leaves.mean[2, 1] = float("nan")
    if not sqrt:
        leaves.fac[4] -= 50 * torch.eye(s_pad, dtype=dtype, device=card)
    arena._det_leaf().copy_(torch.as_tensor(
        np.abs(rng.normal(size=(b + 1, 6, n_pad))), dtype=dtype))
    return arena


def _dispatch(card, dtype, g, k, n_pad, seed=5):
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(size=(g, k, n_pad)), dtype=dtype,
                        device=card)
    y[1, 0, 2] = 30.0
    mask = torch.as_tensor(rng.uniform(size=(g, k, n_pad)) > 0.1,
                           device=card)
    mask[3] = False
    real = torch.ones((g, n_pad), dtype=torch.bool, device=card)
    return y, mask, real


def _rel_nan(got, want):
    """:func:`_rel` NaN-strict: the NaN patterns must match (the gate-off
    sequential body's z-scores are NaN everywhere)."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if not torch.isfinite(want).any():
        return 0.0
    return _rel(got, want)


def _same_rows(a, b, rows):
    return all(torch.equal(a[r].nan_to_num(7.0), b[r].nan_to_num(7.0))
               for r in rows)


@pytest.mark.parametrize("body,mode,lik", ARENA_MODES)
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_arena_update_kernel_matches_plain(card, dtype, bar, body, mode,
                                           lik):
    """K16 against its plain version: every output and every written
    leaf; a rejected row and the rows not named stay bit-identical."""
    from metran_tpu_torch.kernels import arena as karena

    sqrt = body == "sqrt"
    rows = [3, 2, 4, 1, 5, 7, 8, 10]
    g, k = len(rows), 2
    y, mask, real = _dispatch(card, dtype, g, k, 8)
    rob = None
    if lik is not None:
        rob = karena.ArenaRobust(lik, 4.0, *(
            torch.full((g, 8), v, dtype=dtype, device=card)
            for v in (-0.5, 0.8, 0.3, 0.05)))
    det = body != "joint" and (mode != "off" or lik is not None)
    kw = dict(body=body, mode=mode, min_seen=20, robust=rob,
              steady_tol=1e-2, real=real, det_min_seen=10,
              det_params=DET_PARAMS)
    outs, arenas = [], []
    for fn in (karena.arena_update_kernel, karena.arena_update_plain):
        arena = _arena(card, dtype, sqrt)
        outs.append(fn(*arena._dynamic(), *arena._static(), rows, y, mask,
                       det=arena._det_leaf() if det else None, **kw))
        arenas.append(arena)
    torch.cuda.synchronize()
    got, want = outs
    assert torch.equal(got.ok, want.ok)
    assert not got.ok[1] and (sqrt or not got.ok[2])
    for field in ("sigma", "detf", "zscore", "iters", "det_stats"):
        g_, w_ = getattr(got, field), getattr(want, field)
        if w_ is not None:
            assert _rel_nan(g_[want.ok], w_[want.ok]) <= bar, field
    for field in ("verdict", "det_counts", "conv"):
        if getattr(want, field) is not None:
            assert torch.equal(getattr(got, field), getattr(want, field))
    ka, pa = arenas
    fk, fp = leaves_of(ka).fac, leaves_of(pa).fac
    if sqrt:
        fk, fp = fk @ fk.mT, fp @ fp.mT
    assert _rel(leaves_of(ka).mean, leaves_of(pa).mean) <= bar
    assert _rel(fk, fp) <= bar
    assert torch.equal(leaves_of(ka).t_seen, leaves_of(pa).t_seen)
    assert torch.equal(leaves_of(ka).version, leaves_of(pa).version)
    fresh = _arena(card, dtype, sqrt)
    untouched = [0, 6, 9, 11, 12] + [rows[i] for i in
                                     torch.nonzero(~got.ok).flatten()]
    for leaf, ref in zip(ka._dynamic() + (ka._det_leaf(),),
                         fresh._dynamic() + (fresh._det_leaf(),)):
        assert _same_rows(leaf, ref, untouched)


@pytest.mark.parametrize("mode,seq", [("off", False), ("reject", True),
                                      ("huber", False)])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_arena_steady_kernel_matches_plain(card, dtype, bar, mode, seq):
    """K17 against its plain version, frozen rows beside broken ones."""
    from metran_tpu_torch.kernels import arena as karena

    rng = np.random.default_rng(9)
    rows = [3, 2, 4, 1, 5, 7, 8, 10]
    g, k = len(rows), 2
    y, mask, real = _dispatch(card, dtype, g, k, 8, seed=7)
    mask[:] = True
    mask[5, 1, 0] = False  # breaks time-invariance
    steady = torch.as_tensor(rng.uniform(size=13) > 0.3, device=card)
    kgain = torch.as_tensor(rng.normal(size=(13, 16, 8)) * 0.1,
                            dtype=dtype, device=card)
    fdiag = torch.as_tensor(rng.uniform(0.5, 2.0, (13, 8)), dtype=dtype,
                            device=card)
    outs, arenas = [], []
    for fn in (karena.arena_steady_update_kernel,
               karena.arena_steady_update_plain):
        arena = _arena(card, dtype, False)
        leaves_of(arena).mean[2, 1] = 0.5
        outs.append(fn(*k17_leaves(arena), steady, kgain, fdiag, rows,
                       real, y, mask, mode=mode, sequential=seq,
                       min_seen=20, det=arena._det_leaf(), det_min_seen=10,
                       det_params=DET_PARAMS))
        arenas.append(arena)
    torch.cuda.synchronize()
    got, want = outs
    assert torch.equal(got.applied, want.applied)
    assert got.applied.any() and not got.applied.all()
    for field in ("sigma", "detf", "zscore", "det_stats"):
        assert _rel_nan(getattr(got, field), getattr(want, field)) <= bar
    assert torch.equal(got.verdict, want.verdict)
    assert torch.equal(got.det_counts, want.det_counts)
    ka, pa = arenas
    assert _rel(leaves_of(ka).mean, leaves_of(pa).mean) <= bar
    assert torch.equal(leaves_of(ka).t_seen, leaves_of(pa).t_seen)
    assert torch.equal(leaves_of(ka).fac, leaves_of(pa).fac)  # never touched


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_arena_forecast_kernel_matches_plain(card, dtype, bar, sqrt):
    """K18 against its plain version."""
    from metran_tpu_torch.kernels import arena as karena

    arena = _arena(card, dtype, sqrt)
    leaves_of(arena).mean[2, 1] = 0.5
    leaves_of(arena).fac[4] += 60 * torch.eye(16, dtype=dtype, device=card)
    rows = [3, 2, 4, 1, 5]
    hz = torch.arange(1, 13, device=card).to(dtype)
    got = karena.arena_forecast_kernel(*arena._dynamic()[:2],
                                       *arena._static(), rows, hz, sqrt)
    want = karena.arena_forecast_plain(*arena._dynamic()[:2],
                                       *arena._static(), rows, hz, sqrt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar


HORIZON_SETS = [(1, 2, 3, 4, 5), (1, 7, 30)]


@pytest.mark.parametrize("horizons", HORIZON_SETS)
@pytest.mark.parametrize("body,mode,lik", [("joint", "off", None),
                                           ("gated", "reject", None),
                                           ("sqrt", "off", None),
                                           ("sqrt", "inflate", None)])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_arena_update_horizons_kernel_matches_plain(card, dtype, bar, body,
                                                    mode, lik, horizons):
    """K16's horizons mode against its plain version (NaN-strict: the
    poisoned row's moments are its prior's), and at f64 the snapshot of
    every written row equals K18's read of it bit for bit."""
    from metran_tpu_torch.kernels import arena as karena

    sqrt = body == "sqrt"
    rows = [3, 2, 4, 1, 5, 7, 8, 10]
    g, k = len(rows), 1
    y, mask, real = _dispatch(card, dtype, g, k, 8)
    hz = torch.tensor(horizons, dtype=dtype, device=card)
    kw = dict(body=body, mode=mode, min_seen=20, horizons=hz)
    outs, arenas = [], []
    for fn in (karena.arena_update_kernel, karena.arena_update_plain):
        arena = _arena(card, dtype, sqrt)
        outs.append(fn(*arena._dynamic(), *arena._static(), rows, y, mask,
                       **kw))
        arenas.append(arena)
    torch.cuda.synchronize()
    got, want = outs
    assert torch.equal(got.ok, want.ok)
    assert tuple(got.fmeans.shape) == (g, len(horizons), 8)
    for field in ("fmeans", "fvars"):
        assert _rel_nan(getattr(got, field), getattr(want, field)) <= bar
    ka = arenas[0]
    fm, fv = karena.arena_forecast_kernel(*ka._dynamic()[:2], *ka._static(),
                                          rows, hz, sqrt)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        assert torch.equal(got.fmeans.nan_to_num(7.0), fm.nan_to_num(7.0))
        assert torch.equal(got.fvars.nan_to_num(7.0), fv.nan_to_num(7.0))


@pytest.mark.parametrize("horizons", HORIZON_SETS)
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_steady_horizons_kernels_match_plain(card, dtype, bar, horizons):
    """K14's and K17's horizons modes against their plain versions; at f64
    K17's means of an applied row equal K18's read of it bit for bit."""
    from metran_tpu_torch.kernels import arena as karena

    hz = torch.tensor(horizons, dtype=dtype, device=card)
    phi, z, gains, real, mean, y, mask, armed = _steady_case(card, dtype)
    got = kernels.steady_filter(phi, z, gains[2], gains[3], real, mean, y,
                                mask, armed, "huber", 16.0, False,
                                horizons=hz)
    want = kernels.steady_filter_plain(phi, z, gains[2], gains[3], real,
                                       mean, y, mask, armed, "huber", 16.0,
                                       False, horizons=hz)
    torch.cuda.synchronize()
    assert len(got) == 7 and _rel(got[6], want[6]) <= bar
    rng = np.random.default_rng(9)
    rows = [3, 2, 4, 1, 5, 7, 8, 10]
    yd, md, rd = _dispatch(card, dtype, len(rows), 1, 8, seed=7)
    md[:] = True
    md[5, 0, 0] = False
    steady = torch.as_tensor(rng.uniform(size=13) > 0.3, device=card)
    kgain = torch.as_tensor(rng.normal(size=(13, 16, 8)) * 0.1,
                            dtype=dtype, device=card)
    fdiag = torch.as_tensor(rng.uniform(0.5, 2.0, (13, 8)), dtype=dtype,
                            device=card)
    outs, arenas = [], []
    for fn in (karena.arena_steady_update_kernel,
               karena.arena_steady_update_plain):
        arena = _arena(card, dtype, False)
        leaves_of(arena).mean[2, 1] = 0.5
        outs.append(fn(*k17_leaves(arena), steady, kgain, fdiag, rows, rd,
                       yd, md, horizons=hz))
        arenas.append(arena)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].applied, outs[1].applied)
    assert _rel(outs[0].fmeans, outs[1].fmeans) <= bar
    ka = arenas[0]
    fm, _ = karena.arena_forecast_kernel(*ka._dynamic()[:2], *ka._static(),
                                         rows, hz, False)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        assert torch.equal(outs[0].fmeans, fm)


def _scan_inputs(card, dtype, b=3, t=45, n=5, kf=2):
    """A small fleet for the associative-scan kernels K19-K22: masked
    cells, an all-missing step, and (third model) an observed slot with
    r < 0, whose innovation covariance never factors."""
    rng = np.random.default_rng(2)
    ss = dfm_statespace(rng.uniform(5, 40, (b, n)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, n, kf)), 1.0, device=card,
                        dtype=dtype)
    y = torch.as_tensor(rng.normal(size=(b, t, n)), dtype=dtype, device=card)
    mask = torch.as_tensor(rng.uniform(size=(b, t, n)) > 0.3, device=card)
    mask[:, 7] = False
    r = ss.r.clone()
    r[2, 1] = -2.0
    return ss.phi, ss.q, ss.z, r, y, mask


def _scan_rel(got, want, factor):
    if factor:  # square-root factors through S S'
        got, want = got @ got.mT, want @ want.mT
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    return _rel(got, want)


@pytest.mark.parametrize("chunk", [45, 8, 1])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_parallel_scan_kernels_match_plain(card, dtype, bar, chunk):
    """K19/K20 and K21/K22 against their plain versions on the same
    chunks (one chunk, a ragged tail, one step per chunk), with and
    without the stored moments."""
    from metran_tpu_torch.kernels import pkalman as kpk

    phi, q, z, r, y, mask = _scan_inputs(card, dtype)
    qd = torch.diagonal(q, 0, -2, -1).contiguous()
    for sqrt, fk, fp, sk, sp, qq in (
            (False, kpk.parallel_filter_kernel, kpk.parallel_filter_plain,
             kpk.parallel_smooth_kernel, kpk.parallel_smooth_plain, q),
            (True, kpk.sqrt_parallel_filter_kernel,
             kpk.sqrt_parallel_filter_plain, kpk.sqrt_parallel_smooth_kernel,
             kpk.sqrt_parallel_smooth_plain, qd)):
        for store in (True, False):
            got = fk(phi, qq, z, r, y, mask, chunk, store)
            want = fp(phi, qq, z, r, y, mask, chunk, store)
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                assert _scan_rel(g, w, sqrt and g.dim() >= 3
                                 and g.shape[-1] == g.shape[-2]) <= bar, (
                    sqrt, store, i)
            assert bool(torch.isinf(got[-1][2]).any())  # r < 0: +inf
        full = fp(phi, qq, z, r, y, mask, chunk)
        sargs = ((phi, qd) if sqrt else (phi,)) + (full[2], full[3],
                                                   full[0], full[1])
        got = sk(*sargs, chunk)
        want = sp(*sargs, chunk)
        torch.cuda.synchronize()
        assert _scan_rel(got[0], want[0], False) <= bar
        assert _scan_rel(got[1], want[1], sqrt) <= bar


@pytest.mark.parametrize("chunk", [4, 3, 1])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_sharded_scan_modes_match_plain(card, dtype, bar, chunk):
    """K19/K20's ``total``, ``carry`` and ``prefix`` modes against their
    plain versions on three shards of 15 steps (uneven chunks), the
    origin shard and the others, with and without the stored moments."""
    from metran_tpu_torch.kernels import pkalman as kpk

    phi, q, z, r, y, mask = _scan_inputs(card, dtype)
    n, shards = phi.shape[-1], 3
    tl = y.shape[1] // shards
    cut = [slice(k * tl, (k + 1) * tl) for k in range(shards)]
    tots = []
    for k, sl in enumerate(cut):
        args = (phi, q, z, r, y[:, sl], mask[:, sl], chunk)
        got = kpk.parallel_filter_total_kernel(*args, origin=k == 0)
        want = kpk.parallel_filter_total_plain(*args, origin=k == 0)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) <= bar and _rel(got[1], want[1]) <= bar
        tots.append(want)
    totals = torch.stack([t[0] for t in tots], dim=1)
    pre = kpk.parallel_filter_carry_plain(totals, n)
    assert _rel(kpk.parallel_filter_carry_kernel(totals, n), pre) <= bar
    filt = []
    for k, sl in enumerate(cut):
        inc = None if k == 0 else pre[:, k - 1].contiguous()
        for store in (False, True):
            args = (phi, q, z, r, y[:, sl], mask[:, sl], chunk, tots[k][1],
                    inc, store)
            got = kpk.parallel_filter_prefix_kernel(*args)
            want = kpk.parallel_filter_prefix_plain(*args)
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                assert _scan_rel(g, w, False) <= bar, (k, store, i)
        filt.append(want)  # the stored moments
    stots = []
    for k in range(shards):
        halo = None if k == shards - 1 else (filt[k + 1][0][:, 0],
                                             filt[k + 1][1][:, 0])
        args = (phi, filt[k][2], filt[k][3], filt[k][0], filt[k][1], chunk,
                halo)
        got = kpk.parallel_smooth_total_kernel(*args)
        want = kpk.parallel_smooth_total_plain(*args)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) <= bar and _rel(got[1], want[1]) <= bar
        stots.append((want, halo))
    totals = torch.stack([stots[k][0][0] for k in reversed(range(shards))],
                         dim=1)
    spre = kpk.parallel_smooth_carry_plain(totals, n)
    assert _rel(kpk.parallel_smooth_carry_kernel(totals, n), spre) <= bar
    for k in range(shards):
        (_, tot), halo = stots[k]
        inc = None if k == shards - 1 else spre[:, shards - 2 - k]
        args = (phi, filt[k][2], filt[k][3], filt[k][0], filt[k][1], chunk,
                tot, None if inc is None else inc.contiguous(), halo)
        got = kpk.parallel_smooth_prefix_kernel(*args)
        want = kpk.parallel_smooth_prefix_plain(*args)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) <= bar and _rel(got[1], want[1]) <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-5)])
def test_sequence_sharded_filter_on_a_virtual_mesh(card, dtype, bar):
    """``sequence_sharded_filter`` on a virtual mesh of 3 devices, all the
    card, equals the unsharded K19/K20 on the same card (reassociation
    rounding), every sharded mode launched."""
    from metran_tpu_torch.ops import pkalman as pops
    from metran_tpu_torch.ops.statespace import StateSpace
    from metran_tpu_torch.parallel.mesh import make_mesh

    phi, q, z, r, y, mask = _scan_inputs(card, dtype)
    r = r.abs()
    ss = StateSpace(phi, q, z, r)
    mesh = make_mesh(3, ("seq",), devices=[card] * 3)
    kernels.reset_launches()
    filt, smooth = pops.sequence_sharded_filter(ss, y, mask, mesh)
    counts = kernels.launches()
    f0 = pops.parallel_filter(ss, y, mask)
    s0 = pops.parallel_smoother(ss, f0)
    torch.cuda.synchronize()
    for name in ("parallel_filter_total", "parallel_filter_carry",
                 "parallel_filter_prefix", "parallel_smooth_total",
                 "parallel_smooth_carry", "parallel_smooth_prefix"):
        assert counts[name] >= 1, name
    for got, want in zip((*filt, *smooth), (*f0, *s0)):
        assert _rel(got, want) <= bar


# ----------------------------------------------------------------------
# K1: the warp kernel (a group of warps per model) bit for bit the block kernel
# (one block per model) it replaced, in every mode
# ----------------------------------------------------------------------
K1_SEG = 16
# (models, steps, (series, factors), options): short and exact-multiple
# horizons, more models than one block of any width, degraded steps
# (r < 0), the serving bucket's padding (N=24, S=32), N = 40 and 45;
# every case past T = 3 has an all-masked step
K1_CASES = [
    (1, 1, (20, 1), {}),
    (3, K1_SEG - 1, (20, 1), {}),
    (3, K1_SEG, (20, 1), {}),
    (133, 4 * K1_SEG + 5, (20, 1), {}),
    (3, 2 * K1_SEG + 7, (20, 1), {"degraded": True}),
    (3, 2 * K1_SEG + 7, (20, 1), {"padded": True}),
    (3, 2 * K1_SEG + 5, (40, 1), {}),
    (2, 2 * K1_SEG + 5, (45, 1), {}),
]


def _k1_case(card, dtype, b, t, widths, degraded=False, padded=False):
    """K1's arguments from a warm non-diagonal posterior: ``(phi, q, z,
    r, mean, cov, y, mask)``."""
    rng = np.random.default_rng(11)
    big_n, kf = widths
    phi, q, z, r = dfm_statespace(
        rng.uniform(5, 40, (b, big_n)), rng.uniform(10, 60, (b, kf)),
        rng.uniform(0.3, 0.8, (b, big_n, kf)) / kf, 1.0, device=card,
        dtype=dtype)
    r = torch.full_like(r, 0.2)
    mask = rng.uniform(size=(b, t, big_n)) > 0.3
    if t > 3:
        mask[:, 3] = False
    if degraded:
        r[0, 2] = -5.0
        mask[0, :, 2] = False
        mask[0, 1:t:3, 2] = True
    if padded:  # into (24, 32) as the registry pads: unit padding states
        s = phi.shape[1]
        n_pad, s_pad = 24, 32
        phi = torch.cat([phi, phi.new_full((b, s_pad - s), 0.5)], 1)
        q2 = torch.eye(s_pad, dtype=dtype, device=card).repeat(b, 1, 1)
        q2[:, :s, :s] = q
        z = torch.nn.functional.pad(z, (0, s_pad - s, 0, n_pad - big_n))
        r = torch.nn.functional.pad(r, (0, n_pad - big_n), value=1.0)
        q = q2
        mask = np.concatenate([mask, np.zeros((b, t, n_pad - big_n), bool)],
                              2)
    s = phi.shape[1]
    y = torch.as_tensor(np.where(mask, rng.normal(size=mask.shape), 0.0),
                        dtype=dtype, device=card)
    a = rng.normal(size=(b, s, s)) * 0.1
    cov = torch.as_tensor(np.eye(s) + a @ a.transpose(0, 2, 1), dtype=dtype,
                          device=card)
    mean = torch.as_tensor(rng.normal(size=(b, s)) * 0.1, dtype=dtype,
                           device=card)
    return (phi, q, z, r, mean, cov, y, torch.as_tensor(mask, device=card))


def _k1_modes(args, warp):
    """Every mode: carry over all steps and over the first, bounds every
    K1_SEG steps, store."""
    from metran_tpu_torch.kernels import joint_filter as jf

    append = (jf.joint_filter_append_kernel if warp
              else jf.joint_filter_append_block)
    store = jf.joint_filter_store_kernel if warp else jf.joint_filter_store_block
    first = (*args[:6], args[6][:, :1].contiguous(),
             args[7][:, :1].contiguous())
    return [append(*args), append(*first),
            append(*args, bounds_seg=K1_SEG), store(*args)]


def _all_equal(got, want):
    return all(torch.equal(g, w) for mode_g, mode_w in zip(got, want)
               for g, w in zip(mode_g, mode_w))


@pytest.mark.parametrize("case", K1_CASES,
                         ids=lambda c: f"B{c[0]}-T{c[1]}-N{c[2][0]}"
                         + "".join(f"-{k}" for k in c[3]))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_warp_kernel_is_the_block_kernel_bit_for_bit(card, dtype, case):
    """Carry (k steps and one), bounds and store: the warp kernel's every
    output equals the block kernel's; each counts its own launches; the
    warp kernel stays within the plain version's bars."""
    b, t, widths, kw = case
    args = _k1_case(card, dtype, b, t, widths, **kw)
    from metran_tpu_torch.kernels import build

    counts = lambda: (kernels.launches(), build.oracle_launches())  # noqa
    before = counts()
    warp = _k1_modes(args, True)
    mid = counts()
    block = _k1_modes(args, False)
    after = counts()
    torch.cuda.synchronize()
    assert _all_equal(warp, block)

    def diff(a, b, key):
        return b[0][key] - a[0][key] if key in b[0] else b[1][key] - a[1][key]

    keys = ("joint_filter_append", "joint_filter_store",
            "joint_filter_append_block", "joint_filter_store_block")
    assert [diff(before, mid, k) for k in keys] == [3, 1, 0, 0]
    assert [diff(mid, after, k) for k in keys] == [0, 0, 3, 1]
    bar = 1e-9 if dtype == torch.float64 else 1e-3
    plain = kernels.joint_filter_append_plain(*args, bounds_seg=K1_SEG)
    for g, w in zip(warp[2], plain):
        assert _rel(g, w) <= bar


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_warp_kernel_is_the_same_at_every_block_shape(card, dtype,
                                                         monkeypatch):
    """Each launch shape (W models a block, G warps a model; forced
    through the wrapper's chooser) gives the block kernel's bits, with a
    partial last block."""
    from metran_tpu_torch.kernels import joint_filter as jf

    args = _k1_case(card, dtype, 133, 2 * K1_SEG + 3, (20, 1),
                    degraded=True)
    block = _k1_modes(args, False)
    w, g = jf.block_shape(133, 20, 21, dtype, card)
    assert 1 <= w and w * g <= jf.MAX_MODELS and g in (1, jf.MAX_GROUP)
    shapes = [(w, 1) for w in range(1, jf.MAX_MODELS + 1)]
    shapes += [(w, jf.MAX_GROUP)
               for w in range(1, jf.MAX_MODELS // jf.MAX_GROUP + 1)]
    for shape in shapes:
        monkeypatch.setattr(jf, "block_shape", lambda *a, s=shape: s)
        assert _all_equal(_k1_modes(args, True), block), shape


@pytest.mark.parametrize("dtype,widths", [(torch.float32, (88, 8)),
                                          (torch.float64, (64, 8))])
def test_k1_warp_kernel_takes_the_widest_buckets_of_the_block_kernel(
        card, dtype, widths):
    """(88, 96) in f32 and (64, 72) in f64, the widest buckets of eights
    the block kernel (and the joint arena update) takes: the warp kernel
    takes them too, bit for bit, at both group widths."""
    from metran_tpu_torch.kernels import joint_filter as jf

    args = _k1_case(card, dtype, 2, K1_SEG + 3, widths)
    block = _k1_modes(args, False)
    assert _all_equal(_k1_modes(args, True), block)
    for shape in ((1, 1), (1, jf.MAX_GROUP)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jf, "block_shape", lambda *a, s=shape: s)
            assert _all_equal(_k1_modes(args, True), block), shape


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_block_shape_switches_at_the_resident_four_warp_blocks(card,
                                                                  dtype):
    """The occupancy calculator's count for the four-warp launch is where
    block_shape leaves four warps a model, in every mode."""
    from metran_tpu_torch.kernels import joint_filter as jf

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for mode in jf.MODES:
        blocks = jf.occupancy(20, 21, dtype, mode, 1, jf.MAX_GROUP)
        assert 1 <= blocks <= 16
        edge = blocks * sms
        assert jf.block_shape(edge, 20, 21, dtype, card, mode) == (
            1, jf.MAX_GROUP)
        assert jf.block_shape(edge + 1, 20, 21, dtype, card, mode)[1] == 1


def test_k1_warp_layout_is_the_compiled_one(card):
    """The wrapper's mirror of the warp kernel's shared-memory layout
    equals the compiled ``jointw::model_bytes``."""
    from metran_tpu_torch.kernels import build
    from metran_tpu_torch.kernels import joint_filter as jf

    lib = build.load_library("joint_filter")
    for n, s in ((20, 21), (24, 32), (40, 41), (45, 46), (1, 1), (7, 30),
                 (88, 96), (64, 72), (16, 216)):
        assert lib.metran_joint_filter_model_bytes_f32(n, s) == \
            jf.model_bytes(n, s, torch.float32)
        assert lib.metran_joint_filter_model_bytes_f64(n, s) == \
            jf.model_bytes(n, s, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_arena_joint_update_is_the_warp_k1(card, dtype):
    """K16's joint body (``joint_step.cuh``, the block kernel's) and the
    warp K1 at k = 1 on the same rows: the written posterior and the
    terms agree bit for bit."""
    from metran_tpu_torch.kernels import arena as karena

    arena = _arena(card, dtype, False)
    rows = [3, 1, 5, 7, 8, 10, 0]  # the NaN row 2 and non-PSD row 4 out
    y, mask, real = _dispatch(card, dtype, len(rows), 1, 8)
    a = leaves_of(arena)
    idx = torch.as_tensor(rows, device=card)
    k1_args = (a.phi[idx], a.q[idx], a.z[idx], a.r[idx], a.mean[idx],
               a.fac[idx], y, mask)
    k1_args = tuple(t.contiguous() for t in k1_args)
    want = kernels.joint_filter_append_kernel(*k1_args)
    out = karena.arena_update_kernel(
        *arena._dynamic(), *arena._static(), rows, y, mask, body="joint",
        mode="off", min_seen=20, robust=None, steady_tol=0.0, real=real,
        det_min_seen=10, det_params=DET_PARAMS)
    torch.cuda.synchronize()
    assert bool(out.ok.all())
    assert torch.equal(a.mean[idx], want[0])
    assert torch.equal(a.fac[idx], want[1])
    assert torch.equal(out.sigma, want[2])
    assert torch.equal(out.detf, want[3])


# ----------------------------------------------------------------------
# K9: the group kernel (a group of warps per lane) bit for bit the block
# kernel (one block per lane) it replaced, in every instantiation
# ----------------------------------------------------------------------
K9_SEG = 4
# (lanes, steps, (series, factors)): one lane, a few, more lanes than a
# block of any width, 512; the widest buckets of eights the block kernel
# takes ((72, 80) f32, (48, 56) f64) and buckets whose layout drops the
# odd leading dimensions and Z's bits ((73, 82) f32, (40, 62) f64)
K9_CASES = [(1, 9, (20, 1)), (8, 2 * K9_SEG + 3, (20, 1)),
            (64, K9_SEG + 1, (20, 1)), (512, 3, (20, 1))]
K9_WIDE = [(torch.float32, (72, 8)), (torch.float32, (73, 9)),
           (torch.float64, (48, 8)), (torch.float64, (40, 22))]


def _k9_case(card, dtype, b, t, widths):
    """K9's lanes-layout arguments ``(phi, q, z, r, y, mask, lane_map)``
    and a given carry ``(mean0, chol0)`` that is not triangular: lane 0
    observes a NaN reading at step 2, lane b - 1 a slot with r < 0, step 1
    is all masked, step 2 (past T = 2) fully observed."""
    rng = np.random.default_rng(17)
    big_n, kf = widths
    ss = dfm_statespace(rng.uniform(5, 40, (b, big_n)),
                        rng.uniform(10, 60, (b, kf)),
                        rng.uniform(0.3, 0.8, (b, big_n, kf)) / kf, 1.0,
                        device=card, dtype=dtype)
    n = big_n + kf
    r = torch.full((big_n, b), 0.2, dtype=dtype, device=card)
    r[1, b - 1] = -1.0
    mask = rng.uniform(size=(b, t, big_n)) > 0.3
    if t > 1:
        mask[:, 1] = False
    if t > 2:
        mask[:, 2] = True
    y = np.where(mask, rng.normal(size=mask.shape), 0.0)
    if t > 2:
        y[0, 2, 3] = np.nan
    a = rng.normal(size=(b, n, n)) / np.sqrt(n)
    new = dict(dtype=dtype, device=card)
    return ((ss.phi.T.contiguous(),
             torch.diagonal(ss.q, 0, -2, -1).T.contiguous(),
             ss.z.permute(1, 2, 0).contiguous(), r,
             torch.as_tensor(y, **new), torch.as_tensor(mask, device=card),
             torch.arange(b, dtype=torch.int32, device=card)),
            torch.as_tensor(rng.normal(size=(b, n)), **new),
            torch.as_tensor(a, **new))


def _k9_modes(args, m0, c0, group):
    """Every instantiation: store, carry from (0, I) over all steps and
    the first, bounds every K9_SEG steps, carry from a given carry, the
    three gate policies and the three robust likelihoods from it."""
    sf = _sf()
    kind = "kernel" if group else "block"
    run = getattr(sf, f"sqrt_filter_{kind}")
    gated = getattr(sf, f"sqrt_filter_gated_{kind}")
    robust = getattr(sf, f"sqrt_filter_robust_{kind}")
    b, big_n = args[0].shape[1], args[2].shape[0]
    armed = torch.arange(b, device=m0.device) % 3 != 1
    first = (*args[:4], args[4][:, :1].contiguous(),
             args[5][:, :1].contiguous(), args[6])
    out = [run(*args, store=True), run(*args), run(*first),
           run(*args, bounds_seg=K9_SEG), run(*args, mean0=m0, chol0=c0)]
    out += [gated(*args[:6], m0, c0, armed, policy, 1.0, args[6])
            for policy in ("reject", "huber", "inflate")]
    par = [torch.full((b, big_n), v, dtype=m0.dtype, device=m0.device)
           for v in (-0.5, 0.5, 0.1, 0.5)]
    out += [robust(*args[:6], m0, c0, armed, *par, lik, 4.0, args[6])
            for lik in ("censored", "quantized", "huber_t")]
    return out


def _sf():
    import importlib

    return importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")


def _nan_equal(a, b):
    """``torch.equal`` with NaN in the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _k9_equal(got, want):
    return all(_nan_equal(g, w) for mode_g, mode_w in zip(got, want)
               for g, w in zip(mode_g, mode_w))


K9_NAMES = ("sqrt_filter", "sqrt_filter_gated", "sqrt_filter_robust")


@pytest.mark.parametrize("case", K9_CASES,
                         ids=[f"B={c[0]} T={c[1]}" for c in K9_CASES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k9_group_kernel_is_the_block_kernel_bit_for_bit(card, dtype, case):
    """Every instantiation: the group kernel's every output equals the
    block kernel's (NaN in the same places); each counts its own
    launches; the group kernel's store stays within the plain version's
    bars."""
    from metran_tpu_torch.kernels import build

    b, t, widths = case
    args, m0, c0 = _k9_case(card, dtype, b, t, widths)
    counts = lambda: (kernels.launches(), build.oracle_launches())  # noqa
    before = counts()
    group = _k9_modes(args, m0, c0, True)
    mid = counts()
    block = _k9_modes(args, m0, c0, False)
    after = counts()
    torch.cuda.synchronize()
    assert _k9_equal(group, block)
    assert [mid[0][k] - before[0][k] for k in K9_NAMES] == [5, 3, 3]
    assert mid[1] == before[1] and after[0] == mid[0]
    assert [after[1][k + "_block"] - mid[1][k + "_block"]
            for k in K9_NAMES] == [5, 3, 3]
    bar = 1e-9 if dtype == torch.float64 else 1e-3
    plain = kernels.sqrt_filter_plain(*args, store=True)
    for i in (0, 2, 4, 5):
        assert _rel(group[0][i].nan_to_num(0.0),
                    plain[i].nan_to_num(0.0)) <= bar
    if t > 2:  # the r < 0 slot observed at step 2 fails ok: detf = +inf
        assert torch.isinf(group[0][5][b - 1, 2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k9_group_kernel_is_the_same_at_every_launch_shape(card, dtype,
                                                           monkeypatch):
    """Each launch shape (W lanes a block, G warps a lane; forced through
    the wrapper's chooser) gives the block kernel's bits, with a partial
    last block."""
    sf = _sf()
    args, m0, c0 = _k9_case(card, dtype, 13, 2 * K9_SEG + 1, (20, 1))
    block = _k9_modes(args, m0, c0, False)
    w, g = sf.launch_shape(13, 20, 21, dtype, card)
    assert 1 <= w and w * g <= sf.MAX_WARPS
    assert g in (sf.MIN_GROUP, sf.MAX_GROUP)
    fit = sf.MAX_SMEM // sf.model_bytes(20, 21, dtype)
    shapes = [(w, g) for g in (sf.MIN_GROUP, sf.MAX_GROUP)
              for w in range(1, min(sf.MAX_WARPS // g, fit) + 1)]
    for shape in shapes:
        monkeypatch.setattr(sf, "launch_shape", lambda *a, s=shape: s)
        assert _k9_equal(_k9_modes(args, m0, c0, True), block), shape


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k9_group_kernel_past_the_resident_four_warp_blocks(card, dtype):
    """Past residency ``launch_shape`` leaves four warps a lane; the
    two-warp launch it takes is the block kernel's bits too."""
    sf = _sf()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for variant in sf.VARIANTS:
        blocks = sf.occupancy(20, 21, dtype, variant, 1, sf.MAX_GROUP)
        assert 1 <= blocks <= 16
        edge = blocks * sms
        assert sf.launch_shape(edge, 20, 21, dtype, card, variant) == (
            1, sf.MAX_GROUP)
        assert sf.launch_shape(edge + 1, 20, 21, dtype, card,
                               variant)[1] == sf.MIN_GROUP
    edge = sms * sf.occupancy(20, 21, dtype, "carry", 1, sf.MAX_GROUP)
    args, m0, c0 = _k9_case(card, dtype, edge + 5, 3, (20, 1))
    assert _k9_equal(_k9_modes(args, m0, c0, True),
                     _k9_modes(args, m0, c0, False))


@pytest.mark.parametrize("dtype,widths", K9_WIDE)
def test_k9_group_kernel_takes_the_widest_buckets_of_the_block_kernel(
        card, dtype, widths):
    """The widest buckets of eights, and buckets whose group layout drops
    its odd leading dimensions and Z's bits: bit for bit, at both group
    widths."""
    sf = _sf()
    args, m0, c0 = _k9_case(card, dtype, 2, K9_SEG + 3, widths)
    block = _k9_modes(args, m0, c0, False)
    assert _k9_equal(_k9_modes(args, m0, c0, True), block)
    for shape in ((1, sf.MIN_GROUP), (1, sf.MAX_GROUP)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sf, "launch_shape", lambda *a, s=shape: s)
            assert _k9_equal(_k9_modes(args, m0, c0, True), block), shape


def test_k9_group_layout_is_the_compiled_one(card):
    """The wrapper's mirror of the group kernel's shared-memory layout
    equals the compiled ``sqrtw::model_bytes``."""
    from metran_tpu_torch.kernels import build

    sf = _sf()
    lib = build.load_library("sqrt_filter")
    for n_obs, n in ((20, 21), (24, 32), (40, 41), (45, 46), (1, 2), (7, 30),
                     (72, 80), (73, 82), (48, 56), (35, 64), (16, 216)):
        assert lib.metran_sqrt_filter_model_bytes_f32(n_obs, n) == \
            sf.model_bytes(n_obs, n, torch.float32)
        assert lib.metran_sqrt_filter_model_bytes_f64(n_obs, n) == \
            sf.model_bytes(n_obs, n, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k9_group_kernel_from_a_huge_finite_carry(card, dtype):
    """A carry whose squares overflow: a predict reflector's multiplier is
    not finite, and the rest of the QR takes the block kernel's rows, NaN
    in the same places."""
    args, m0, c0 = _k9_case(card, dtype, 3, 4, (20, 1))
    big = 1e25 if dtype == torch.float32 else 1e200
    args = list(args)
    c0 = torch.tril(c0) * big
    m0 = m0 * big
    assert _k9_equal(_k9_modes(args, m0, c0, True),
                     _k9_modes(args, m0, c0, False))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_arena_sqrt_update_is_the_group_k9(card, dtype):
    """K16's square-root body (``sqrt_step.cuh``, the block kernel's) and
    the group K9 at k = 1 on the same rows: the written posterior and the
    terms agree bit for bit."""
    from metran_tpu_torch.kernels import arena as karena

    arena = _arena(card, dtype, True)
    rows = [3, 1, 5, 7, 8, 10, 0, 4]  # the NaN row 2 out
    y, mask, real = _dispatch(card, dtype, len(rows), 1, 8)
    a = leaves_of(arena)
    idx = torch.as_tensor(rows, device=card)
    args = (a.phi[idx].T, torch.diagonal(a.q[idx], 0, -2, -1).T,
            a.z[idx].permute(1, 2, 0), a.r[idx].T, y, mask)
    args = tuple(t.contiguous() for t in args)
    want = kernels.sqrt_filter_kernel(*args, mean0=a.mean[idx].contiguous(),
                                      chol0=a.fac[idx].contiguous())
    out = karena.arena_update_kernel(
        *arena._dynamic(), *arena._static(), rows, y, mask, body="sqrt",
        mode="off", min_seen=20, robust=None, steady_tol=0.0, real=real,
        det_min_seen=10, det_params=DET_PARAMS)
    torch.cuda.synchronize()
    assert bool(out.ok.all())
    assert torch.equal(a.mean[idx], want[0])
    assert torch.equal(a.fac[idx], want[1])
    assert torch.equal(out.sigma, want[2])
    assert torch.equal(out.detf, want[3])


# ----------------------------------------------------------------------
# K4: the ring kernel (replay warps filling a ring of segment records for
# its sweep warps) bit for bit the warp kernel (one warp per lane) it
# replaced.  The cases and their inputs are chip_smoke.py's (K4_CASES,
# _k4_case): the lanes cases of the plain comparisons (padded series, a
# masked series and step, a near-unit-root lane, K = 4 trials over a lane
# map), a NaN reading (a non-finite dvec takes the full row), a seg past
# T, then B = 1, 8, 64 and 512
# ----------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    import sys
    from pathlib import Path

    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


K4_CASES = _chip_smoke().K4_CASES


def _k4_case(card, dtype, case, deviance=False, **extra):
    """``chip_smoke._k4_case`` of ``case`` (a K4_CASES row, its keywords
    updated by ``extra``): K3's boundaries, random cotangents or, with
    ``deviance``, the deviance's."""
    _, d, t, seg, kw = case
    adj, _ = _chip_smoke()._k4_case(np.random.default_rng(23), d, t, seg,
                                    dtype, card, deviance=deviance,
                                    **{**kw, **extra})
    return adj


def _k4_both(args):
    """The ring and the warp kernel on ``args``; each counts its own
    launch."""
    from metran_tpu_torch.kernels import build

    before = (kernels.launches(), build.oracle_launches())
    ring = kernels.lanes_adjoint(*args)
    mid = (kernels.launches(), build.oracle_launches())
    warp = kernels.lanes_adjoint_warp_kernel(*args)
    after = (kernels.launches(), build.oracle_launches())
    torch.cuda.synchronize()
    assert mid[0]["lanes_adjoint"] - before[0]["lanes_adjoint"] == 1
    assert mid[1] == before[1] and after[0] == mid[0]
    assert after[1]["lanes_adjoint_warp"] - mid[1]["lanes_adjoint_warp"] \
        == 1
    return ring, warp


@pytest.mark.parametrize("case", K4_CASES, ids=[c[0] for c in K4_CASES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_ring_kernel_is_the_warp_kernel_bit_for_bit(card, dtype, case):
    args = _k4_case(card, dtype, case)
    ring, warp = _k4_both(args)
    assert all(_nan_equal(g, w) for g, w in zip(ring, warp))
    if case[4].get("nan"):  # lane 0's adjoints are NaN, the others finite
        assert bool(torch.isnan(ring[0][:, 0]).any())
        assert bool(torch.isfinite(ring[0][:, 1:]).all())


@pytest.mark.parametrize("stages,sweep", [(2, 2), (2, 1), (1, 1), (0, 1)])
@pytest.mark.parametrize("ring", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_every_ring_shape_is_the_warp_kernel(card, monkeypatch, dtype,
                                                ring, stages, sweep):
    """Forced shapes: R replay warps over R + 1 slots and over R (fewer
    than the segments, so slots refill); records staged a step ahead
    (one or two sweep warps), after the step before, or read in the
    ring (one)."""
    from metran_tpu_torch.kernels import lanes as kl

    args = _k4_case(card, dtype, ("B=6 T=197 seg=16", 6, 197, 16, {}))
    _, warp = _k4_both(args)
    for depth in (ring + 1, ring):
        monkeypatch.setattr(kl, "ring_geometry",
                            lambda *a, r=ring, d=depth: kl.RingShape(
                                r, d, sweep, stages))
        got = kernels.lanes_adjoint(*args)
        torch.cuda.synchronize()
        assert all(_nan_equal(g, w) for g, w in zip(got, warp))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k4_past_the_resident_blocks_and_at_the_widest_staged_buckets(
        card, dtype):
    from metran_tpu_torch.kernels import lanes as kl

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    edge = sms * kl.adjoint_occupancy(20, 21, dtype, kl.RING_MAX, 2)
    args = _k4_case(card, dtype, ("past", edge + 5, 40, 4, {}))
    shape = kl.ring_geometry(edge + 5, 40, 4, 20, 21, dtype, card)
    assert (shape.ring, shape.sweep, shape.stages) in kl.WIDE
    ring, warp = _k4_both(args)
    assert all(_nan_equal(g, w) for g, w in zip(ring, warp))
    # the widest one-factor buckets that stage two records, then one, the
    # warp kernel's widest (one), bit for bit; past that the ring kernel's
    # own (one, then none, read in the ring) against plain
    two, warp_n, one = ((61, 66, 73) if dtype == torch.float64
                        else (88, 95, 104))
    bar = 1e-9 if dtype == torch.float64 else 1e-3
    for big_n, stages in ((two, 2), (two + 1, 1), (warp_n, 1), (one, 1),
                          (one + 1, 0)):
        args = _k4_case(card, dtype, ("wide", 2, 20, 8, {}),
                        n_pad=big_n - 20)
        got = kl.ring_geometry(2, 20, 8, big_n, big_n + 1, dtype, card)
        assert got.stages == stages
        if big_n <= warp_n:
            ring, warp = _k4_both(args)
            assert all(_nan_equal(g, w) for g, w in zip(ring, warp))
        else:
            assert kl.smem_bytes("adjoint_warp", big_n, big_n + 1,
                                 dtype) > kl.MAX_SMEM
            ring = kernels.lanes_adjoint(*args)
            want = kernels.lanes_adjoint_plain(*args)
            assert all(_rel(g, w) <= bar for g, w in zip(ring, want))


@pytest.mark.parametrize("case", K4_CASES[:5], ids=[c[0] for c in
                                                     K4_CASES[:5]])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_k4_ring_kernel_matches_plain(card, dtype, bar, case):
    """At the deviance's cotangents, as the lanes fit sends them (the
    bit-for-bit cases above take random ones)."""
    args = _k4_case(card, dtype, case, deviance=True)
    got = kernels.lanes_adjoint(*args)
    want = kernels.lanes_adjoint_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if case[4].get("nan"):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            g, w = g.nan_to_num(0.0), w.nan_to_num(0.0)
        assert _rel(g, w) <= bar


def test_k4_near_unit_root_gap_at_random_cotangents_is_the_warp_kernels(
        card):
    """Random cotangents on the near-unit-root lane (every state), f64:
    the ring kernel is the warp kernel bit for bit, and both sit as far
    from the plain version, within chip_smoke.K4_UNIT_ROOT_GAP."""
    case = K4_CASES[1]
    args = _k4_case(card, torch.float64, case, unit_root="all")
    ring, warp = _k4_both(args)
    want = kernels.lanes_adjoint_plain(*args)
    assert all(_nan_equal(g, w) for g, w in zip(ring, warp))
    errs = [_rel(g, w) for g, w in zip(ring, want)]
    assert errs == [_rel(g, w) for g, w in zip(warp, want)]
    assert max(errs) <= _chip_smoke().K4_UNIT_ROOT_GAP, errs


# ----------------------------------------------------------------------
# K3: the chain kernel (a chain warp and update warps a lane) bit for bit
# the warp kernel (one warp per lane) it replaced.  The cases and their
# inputs are chip_smoke.py's (K3_CASES, _k3_case): the lanes cases of the
# plain comparisons, a NaN reading (the lane finishes on the oracle's
# step), seg past T, two and three factors, a dense Z, then B = 1, 8, 64
# and 512
# ----------------------------------------------------------------------
K3_CASES = _chip_smoke().K3_CASES


def _k3_case(card, dtype, case, **extra):
    """``chip_smoke._k3_case`` of ``case`` (a K3_CASES row, its keywords
    updated by ``extra``)."""
    _, d, t, _, kw = case
    args, _ = _chip_smoke()._k3_case(np.random.default_rng(31), d, t, dtype,
                                     card, **{**kw, **extra})
    return args


def _k3_both(args, seg):
    """The chain and the warp kernel on ``args`` with boundaries; each
    counts its own launch."""
    from metran_tpu_torch.kernels import build

    before = (kernels.launches(), build.oracle_launches())
    chain = kernels.lanes_filter(*args, seg=seg, keep_bounds=True)
    mid = (kernels.launches(), build.oracle_launches())
    warp = kernels.lanes_filter_warp_kernel(*args, seg=seg, keep_bounds=True)
    after = (kernels.launches(), build.oracle_launches())
    torch.cuda.synchronize()
    assert mid[0]["lanes_filter"] - before[0]["lanes_filter"] == 1
    assert mid[1] == before[1] and after[0] == mid[0]
    assert after[1]["lanes_filter_warp"] - mid[1]["lanes_filter_warp"] == 1
    return chain, warp


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_chain_kernel_is_the_warp_kernel_bit_for_bit(card, dtype, case):
    args = _k3_case(card, dtype, case)
    chain, warp = _k3_both(args, case[3])
    assert all(_nan_equal(g, w) for g, w in zip(chain, warp))
    if case[4].get("nan"):  # lane 0's terms turn NaN, the others finite
        assert bool(torch.isnan(chain.sigma[:, 0]).any())
        assert bool(torch.isfinite(chain.sigma[:, 1:]).all())


@pytest.mark.parametrize("update_warps", [0, 3])
@pytest.mark.parametrize("factors", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_every_chain_shape_is_the_warp_kernel(card, monkeypatch, dtype,
                                                 factors, update_warps):
    """Forced counts of update warps, one to three factors (two, three
    and four nonzero columns a slot)."""
    from metran_tpu_torch.kernels import lanes as kl

    args = _k3_case(card, dtype, ("B=6", 6, 197, 16, {}), factors=factors)
    _, warp = _k3_both(args, 16)
    monkeypatch.setattr(kl, "chain_shape",
                        lambda *a: kl.ChainShape(update_warps))
    got = kernels.lanes_filter(*args, seg=16, keep_bounds=True)
    torch.cuda.synchronize()
    assert all(_nan_equal(g, w) for g, w in zip(got, warp))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_past_the_resident_blocks_and_at_the_widest_bucket(card, dtype):
    from metran_tpu_torch.kernels import lanes as kl

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    edge = sms * kl.chain_occupancy(20, 21, dtype, 3)
    args = _k3_case(card, dtype, ("past", edge + 5, 40, 4, {}))
    assert kl.chain_shape(edge + 5, 20, 21, dtype, card).update_warps == 0
    chain, warp = _k3_both(args, 4)
    assert all(_nan_equal(g, w) for g, w in zip(chain, warp))
    # the warp kernel's widest one-factor bucket, bit for bit
    warp_n = max(m for m in range(1, 200)
                 if kl.smem_bytes("filter_warp", m, m + 1, dtype)
                 <= kl.MAX_SMEM)
    args = _k3_case(card, dtype, ("wide", 2, 20, 8, {}),
                    n_pad=warp_n - 20)
    chain, warp = _k3_both(args, 8)
    assert all(_nan_equal(g, w) for g, w in zip(chain, warp))


@pytest.mark.parametrize("case", K3_CASES[:5], ids=[c[0] for c in
                                                     K3_CASES[:5]])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-3)])
def test_k3_chain_kernel_matches_plain(card, dtype, bar, case):
    args = _k3_case(card, dtype, case)
    got = kernels.lanes_filter(*args, seg=case[3], keep_bounds=True)
    want = kernels.lanes_filter_plain(*args, seg=case[3], keep_bounds=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if case[4].get("nan"):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            g, w = g.nan_to_num(0.0), w.nan_to_num(0.0)
        assert _rel(g, w) <= bar
