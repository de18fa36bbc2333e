"""Port parity: the batch-layout closed-form adjoint
(``metran_tpu_torch.ops.adjoint``: the engines' forward with segment
boundaries, the plain version of kernel K11 backward) against
``metran_tpu.ops.adjoint``, f64 on the CPU.

Tolerances: ``(phibar, qbar)`` against ``jax.vjp`` of the JAX function at
rel 1e-10 normwise in the four alpha regimes of ``tests/test_adjoint.py``
(the JAX package's own bar for adjoint vs autodiff); against the port's
autodiff through the plain filter at the same bar; across segment
lengths 1e-12 (the sweep's arithmetic is the same, only the replay's
starting carries move); values bit-identical to the engine's own
un-differentiated terms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metran_tpu.ops import adjoint as jadj
from metran_tpu.ops import dfm_statespace as jdfm
from metran_tpu.ops import sqrt_filter_append as jsqrt_append
from metran_tpu.ops.statespace import StateSpace as JStateSpace
from metran_tpu_torch.kernels import joint_adjoint, joint_adjoint_plain
from metran_tpu_torch.ops import adjoint as padj
from metran_tpu_torch.ops import kalman as pk
from metran_tpu_torch.ops.statespace import StateSpace, dfm_statespace

# one torch thread per test process (see tests/test_torch_metran.py)
torch.set_num_threads(1)

N, K, T = 4, 1, 60
SEG = 16  # four segments, the last one short
ALPHAS = {  # tests/test_adjoint.py's regimes
    "init": np.full(N + K, 10.0),
    "fast": np.full(N + K, 0.1),
    "near_unit_root": np.full(N + K, 3e4),
    "mixed": np.concatenate([np.linspace(0.1, 100.0, N), [1e4]]),
}
RTOL = 1e-10
ENGINES = ("joint", "sqrt", "sequential")


def _panel(seed=0, t=T):
    rng = np.random.default_rng(seed)
    loadings = rng.uniform(0.4, 0.8, (N, K))
    y = rng.normal(size=(t, N))
    mask = rng.uniform(size=(t, N)) > 0.3
    mask[5] = False  # an all-masked step
    mask[:, -1] &= np.arange(t) % 3 == 0  # a sparse series
    return np.where(mask, y, 0.0), mask, loadings


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _cotangents(seed=1, t=T):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, t), rng.uniform(0.5, 1.5, t)


@functools.partial(jax.jit, static_argnames=("engine", "seg"))
def _jax_vjp_jit(phi, qd, z, r, y, mask, sb, db, engine, seg):
    def terms(phi, qd):
        ss = JStateSpace(phi, jnp.diag(qd), z, r)
        return jadj.adjoint_deviance_terms(ss, y, mask, engine=engine,
                                           seg=seg)

    (sig, det), vjp = jax.vjp(terms, phi, qd)
    return (sig, det), vjp((sb, db))


def _jax_vjp(phi, qd, z, r, y, mask, engine, seg, sb, db):
    """``jax.vjp`` of the JAX ``adjoint_deviance_terms`` (one compile per
    engine, shared by the regimes)."""
    (sig, det), (gp, gq) = _jax_vjp_jit(
        *(jnp.asarray(a) for a in (phi, qd, z, r, y, mask, sb, db)),
        engine=engine, seg=seg)
    return (np.asarray(sig), np.asarray(det)), (np.asarray(gp),
                                                np.asarray(gq))


def _port_vjp(phi, qd, z, r, y, mask, engine, seg, sb, db, grad="adjoint"):
    phi_t = torch.tensor(np.asarray(phi), requires_grad=True)
    qd_t = torch.tensor(np.asarray(qd), requires_grad=True)
    ss = StateSpace(phi_t, torch.diag_embed(qd_t),
                    torch.tensor(np.asarray(z)), torch.tensor(np.asarray(r)))
    if grad == "adjoint":
        sig, det = padj.adjoint_deviance_terms(ss, y, mask, engine=engine,
                                               seg=seg, device="cpu")
    else:  # autodiff through the engine's plain filter
        out = pk._batch_terms(StateSpace(*(leaf[None] for leaf in ss)),
                              torch.tensor(y)[None], torch.tensor(mask)[None],
                              engine, "autodiff", None)
        sig, det = out[0][0], out[1][0]
    g = torch.autograd.grad((sig * torch.tensor(sb)).sum()
                            + (det * torch.tensor(db)).sum(), (phi_t, qd_t))
    return (sig.detach().numpy(), det.detach().numpy()), g


@pytest.mark.parametrize("regime", sorted(ALPHAS))
@pytest.mark.parametrize("engine", ["joint", "sqrt"])
def test_vjp_matches_jax_in_every_regime(engine, regime):
    y, mask, loadings = _panel()
    a = ALPHAS[regime]
    ss = jdfm(a[:N], a[N:], loadings, 1.0)
    qd = np.diagonal(np.asarray(ss.q))
    sb, db = _cotangents()
    (ws, wd), (wp, wq) = _jax_vjp(ss.phi, qd, ss.z, ss.r, y, mask, engine,
                                  SEG, sb, db)
    (gs, gd), (gp, gq) = _port_vjp(ss.phi, qd, ss.z, ss.r, y, mask, engine,
                                   SEG, sb, db)
    # the terms at tests/test_torch_kalman.py's joint-engine bar (LAPACK
    # and XLA factor the same matrices)
    np.testing.assert_allclose(gs, ws, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gd, wd, rtol=1e-10, atol=1e-12)
    assert _rel(gp.numpy(), wp) < RTOL, regime
    assert _rel(gq.numpy(), wq) < RTOL, regime


@pytest.mark.parametrize("engine", ["joint", "sqrt"])
def test_adjoint_matches_the_ports_autodiff(engine):
    """The closed form against torch autograd through the engine's plain
    filter (the gradient the adjoint replaces)."""
    y, mask, loadings = _panel(seed=2)
    a = ALPHAS["mixed"]
    ss = jdfm(a[:N], a[N:], loadings, 1.0)
    qd = np.diagonal(np.asarray(ss.q))
    sb, db = _cotangents(seed=3)
    args = (ss.phi, qd, ss.z, ss.r, y, mask, engine, SEG, sb, db)
    (vs, vd), (gp, gq) = _port_vjp(*args)
    (as_, ad), (ap, aq) = _port_vjp(*args, grad="autodiff")
    assert np.array_equal(vs, as_) and np.array_equal(vd, ad)
    assert _rel(gp.numpy(), ap.numpy()) < RTOL
    assert _rel(gq.numpy(), aq.numpy()) < RTOL


@pytest.mark.parametrize("engine", ENGINES)
def test_values_bit_identical_to_the_engines_own_terms(engine):
    """Differentiable or not, the terms are the engine's own filter
    terms, and the deviance the adjoint path sums is the plain one."""
    y, mask, loadings = _panel(seed=4)
    a = ALPHAS["mixed"]
    ss = dfm_statespace(a[:N], a[N:], loadings, device="cpu")
    sig, det = padj.adjoint_deviance_terms(ss, y, mask, engine=engine)
    p = torch.tensor(a, requires_grad=True)
    ss_g = dfm_statespace(p[:N], p[N:], loadings, device="cpu")
    sig_g, det_g = padj.adjoint_deviance_terms(ss_g, y, mask, engine=engine,
                                               seg=SEG)
    assert torch.equal(sig, sig_g.detach())
    assert torch.equal(det, det_g.detach())
    if engine == "sequential":
        ref = pk.kalman_filter(ss, y, mask, engine="sequential", store=False)
        want_s, want_d = ref.sigma, ref.detf
    elif engine == "sqrt":
        ref = pk.sqrt_kalman_filter(ss, y, mask, store=False)
        want_s, want_d = ref.sigma, ref.detf
    else:
        ref = pk.kalman_filter(ss, y, mask, engine="joint", store=False)
        want_s, want_d = ref.sigma, ref.detf
    assert torch.equal(sig, want_s) and torch.equal(det, want_d)
    value = pk.deviance(ss, y, mask, engine=engine, grad="autodiff")
    dev_g = pk.deviance(ss_g, y, mask, engine=engine, grad="adjoint")
    assert float(dev_g) == float(value)


@pytest.mark.parametrize("engine", ENGINES)
def test_segment_length_does_not_change_the_gradient(engine):
    y, mask, loadings = _panel(seed=5)
    a = ALPHAS["mixed"]
    ss = jdfm(a[:N], a[N:], loadings, 1.0)
    qd = np.diagonal(np.asarray(ss.q))
    sb, db = _cotangents(seed=6)
    grads = [_port_vjp(ss.phi, qd, ss.z, ss.r, y, mask, engine, seg, sb,
                       db)[1] for seg in (1, 7, 128, T)]
    for gp, gq in grads[1:]:
        assert _rel(gp.numpy(), grads[0][0].numpy()) < 1e-12
        assert _rel(gq.numpy(), grads[0][1].numpy()) < 1e-12


def test_data_cotangents_exactly_zero():
    """``z``/``r``/``y`` (and the mask) are fixed data: their cotangents
    are exactly zero, never silently partial (``tests/test_adjoint.py``)."""
    y, mask, loadings = _panel(seed=7)
    a = ALPHAS["init"]
    ss = dfm_statespace(a[:N], a[N:], loadings, device="cpu")
    for engine in ENGINES:
        z = ss.z.clone().requires_grad_(True)
        r = ss.r.clone().requires_grad_(True)
        yt = torch.tensor(y, requires_grad=True)
        phi = ss.phi.clone().requires_grad_(True)
        sig, det = padj.adjoint_deviance_terms(
            StateSpace(phi, ss.q, z, r), yt, mask, engine=engine, seg=SEG)
        gz, gr, gy, gphi = torch.autograd.grad(sig.sum() + det.sum(),
                                               (z, r, yt, phi))
        for g in (gz, gr, gy):
            assert g is not None and torch.count_nonzero(g) == 0, engine
        assert torch.count_nonzero(gphi) > 0


def test_degraded_step_passes_through_as_in_jax():
    """An observed slot with r < 0 makes its steps' innovation covariance
    indefinite: the filter books +inf there and the sweep passes the
    adjoint through, as the JAX function does."""
    y, mask, loadings = _panel(seed=8)
    a = ALPHAS["init"]
    ss = jdfm(a[:N], a[N:], loadings, 1.0)
    r = np.zeros(N)
    r[1] = -50.0
    qd = np.diagonal(np.asarray(ss.q))
    sb, db = _cotangents(seed=9)
    (ws, wd), (wp, wq) = _jax_vjp(ss.phi, qd, ss.z, r, y, mask, "joint",
                                  SEG, sb, db)
    (gs, gd), (gp, gq) = _port_vjp(ss.phi, qd, ss.z, r, y, mask, "joint",
                                   SEG, sb, db)
    assert np.isinf(wd).any()
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-10, atol=1e-12)
    assert _rel(gp.numpy(), wp) < RTOL
    assert _rel(gq.numpy(), wq) < RTOL


def _anchor(seed=4):
    rng = np.random.default_rng(seed)
    s = N + K
    m0 = rng.normal(size=s) * 0.3
    a = rng.normal(size=(s, s)) * 0.3
    return m0, np.linalg.cholesky(a @ a.T + 0.5 * np.eye(s)) @ \
        np.linalg.qr(rng.normal(size=(s, s)))[0]  # not triangular


def test_anchored_value_and_gradient_match_jax():
    y, mask, loadings = _panel(seed=10, t=40)
    m0, c0 = _anchor()
    a = ALPHAS["mixed"]
    ss = dfm_statespace(a[:N], a[N:], loadings, device="cpu")
    value = padj.anchored_adjoint_deviance(ss, m0, c0, y, mask)
    _, _, sig, det = pk.sqrt_filter_append(ss, m0, c0, y, mask)
    assert float(value) == float(sig.sum() + det.sum())
    _, _, jsig, jdet = jsqrt_append(jdfm(a[:N], a[N:], loadings, 1.0), m0,
                                    c0, y, mask)
    assert float(value) == pytest.approx(float(jnp.sum(jsig) + jnp.sum(jdet)),
                                         rel=1e-12)
    gj = jax.grad(lambda x: jadj.anchored_adjoint_deviance(
        jdfm(x[:N], x[N:], loadings, 1.0), m0, c0, y, mask))(jnp.asarray(a))
    p = torch.tensor(a, requires_grad=True)
    m_t = torch.tensor(m0, requires_grad=True)
    c_t = torch.tensor(c0, requires_grad=True)
    got = padj.anchored_adjoint_deviance(
        dfm_statespace(p[:N], p[N:], loadings, device="cpu"), m_t, c_t, y,
        mask)
    gp, gm, gc = torch.autograd.grad(got, (p, m_t, c_t))
    assert _rel(gp.numpy(), gj) < RTOL
    assert torch.count_nonzero(gm) == 0 and torch.count_nonzero(gc) == 0


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    from metran_tpu_torch.kernels import build

    y, mask, loadings = _panel(seed=11, t=20)
    a = ALPHAS["init"]
    ss = dfm_statespace(a[:N], a[N:], loadings, device="cpu")
    b_m, b_c = ss.phi.new_zeros((1, 2, N + K)), torch.eye(N + K)[None].repeat(
        1, 2, 1, 1).double()
    args = (ss.phi[None], torch.diagonal(ss.q)[None], ss.z[None],
            ss.r[None], torch.tensor(y)[None], torch.tensor(mask)[None],
            b_m, b_c, torch.ones(1, 20, dtype=torch.float64),
            torch.ones(1, 20, dtype=torch.float64))
    build.reset_launches()
    got = joint_adjoint(*args, 10)
    want = joint_adjoint_plain(*args, 10)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.launches()["joint_adjoint"] == 0
    with pytest.raises(ValueError, match="bounds_mean"):
        joint_adjoint(*args, 7)  # 3 segments need 3 boundaries


# ----------------------------------------------------------------------
# K11's launch geometry: the ring depth, the ring's shape and the layout
# (pure Python; the kernel itself runs on the card)
# ----------------------------------------------------------------------
def _k11_source():
    from pathlib import Path

    import metran_tpu_torch.kernels as kpkg

    return (Path(kpkg.__file__).parent / "csrc" / "joint_adjoint.cu"
            ).read_text()


def _k11_module():
    import importlib  # the package re-exports the function of that name

    return importlib.import_module("metran_tpu_torch.kernels.joint_adjoint")


def _takes(text, big_n, n):
    """Values a run of ``b.take(base, <expr>)`` calls allocates."""
    import re

    env = {"N": big_n, "n": n, "nn": n * n, "nN": n * big_n}
    return sum(eval(e.replace("(size_t)", ""), {}, dict(env))
               for e in re.findall(r"b\.take\(base, ([^;]+)\);", text))


@pytest.mark.parametrize("big_n,n,ring", [(20, 21, 4), (5, 7, 1),
                                          (40, 41, 2), (3, 30, 3)])
def test_k11_layout_mirrors_the_sources_carve(big_n, n, ring):
    ja = _k11_module()
    src = _k11_source()
    carve = src[src.index("size_t carve(T* base"):]
    carve = carve[:carve.index("return b.used;")]
    sweep = _takes(carve, big_n, n)
    replay = src[src.index("Replay<T> replay_ws("):]
    replay = replay[:replay.index("*count = b.used;")]
    per_warp = _takes(replay, big_n, n)
    want = sweep + ring * per_warp
    assert ja._layout(big_n, n, ring) == want
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        assert ja.smem_bytes(big_n, n, dtype, ring) == want * item


def test_k11_ring_depth_at_the_flagship_and_at_the_edges():
    ja = _k11_module()
    # the flagship (N=20, n=21): four replay warps in shared memory
    assert ja.ring_depth(20, 21, torch.float32, 40) == (4, False)
    assert ja.ring_depth(20, 21, torch.float64, 40) == (4, False)
    # never more warps than segments, never fewer than one
    assert ja.ring_depth(20, 21, torch.float32, 2) == (2, False)
    assert ja.ring_depth(20, 21, torch.float32, 1) == (1, False)
    assert ja.ring_depth(20, 21, torch.float32, 0) == (1, False)
    # wide: as many as fit (f64 at N=40, n=41 fits one)
    ring, spill = ja.ring_depth(40, 41, torch.float64, 40)
    assert (ring, spill) == (1, False)
    room = ja.MAX_SMEM - ja.STATIC_SMEM
    assert ja.smem_bytes(40, 41, torch.float64, 1) <= room
    assert ja.smem_bytes(40, 41, torch.float64, 2) > room
    # too wide for shared memory at any depth: the workspace spills
    assert ja.ring_depth(45, 46, torch.float64, 40) == (4, True)


def _old_k11_smem(big_n, n, item):
    """The shared memory the one-block-per-model K11 took before the
    ring (5n^2 + 6nN + N^2 + 10n + 6N values)."""
    return (5 * n * n + 6 * n * big_n + big_n * big_n + 10 * n
            + 6 * big_n) * item


@pytest.mark.parametrize("dtype,item", [(torch.float32, 4),
                                        (torch.float64, 8)])
def test_k11_takes_every_shape_the_earlier_kernel_took(dtype, item):
    ja = _k11_module()
    for big_n in (1, 2, 5, 20, 31, 32, 33, 40, 64, 100):
        for n in range(big_n, big_n + 80, 7):
            ring, spill = ja.ring_depth(big_n, n, dtype, 40)
            assert 1 <= ring <= ja.RING_MAX
            room = ja.MAX_SMEM - ja.STATIC_SMEM
            if not spill:
                assert ja.smem_bytes(big_n, n, dtype, ring) <= room
            if _old_k11_smem(big_n, n, item) <= ja.MAX_SMEM:
                # what ran before still runs, in shared memory when the
                # one-warp ring fits there beside the barriers
                if ja.smem_bytes(big_n, n, dtype, 1) <= room:
                    assert not spill


def test_k11_static_barriers_mirror_the_source_and_leave_room(monkeypatch):
    """The block's static shared memory (a full and an empty mbarrier of
    8 bytes per slot) is left out of the dynamic layout's room: a layout
    that would fit only without it takes one ring slot fewer, or
    spills."""
    import re

    ja = _k11_module()
    src = _k11_source()
    assert int(re.search(r"constexpr int kMaxRing = (\d+);", src)[1]) \
        == ja.RING_MAX
    assert re.search(r"__shared__ __align__\(8\) uint64_t "
                     r"full\[kMaxRing\], empty\[kMaxRing\];", src)
    assert ja.STATIC_SMEM == 2 * ja.RING_MAX * 8
    real = ja._layout
    # exactly MAX_SMEM bytes at depth 2 leaves no room for the barriers:
    # depth 1; the same at every depth: the workspace spills; MAX_SMEM
    # less the barriers fits
    monkeypatch.setattr(ja, "_layout", lambda big_n, n, ring: (
        ja.MAX_SMEM // 4 if ring >= 2 else real(big_n, n, ring)))
    assert ja.ring_depth(20, 21, torch.float32, 2) == (1, False)
    monkeypatch.setattr(ja, "_layout", lambda *a: ja.MAX_SMEM // 4)
    assert ja.ring_depth(20, 21, torch.float32, 2) == (2, True)
    monkeypatch.setattr(ja, "_layout",
                        lambda *a: (ja.MAX_SMEM - ja.STATIC_SMEM) // 4)
    assert ja.ring_depth(20, 21, torch.float32, 2) == (2, False)


@pytest.mark.parametrize("t_steps,seg", [(5000, 128), (1, 128), (127, 128),
                                         (128, 128), (517, 128), (0, 16)])
def test_k11_ring_scratch_shape_and_bound(t_steps, seg):
    ja = _k11_module()
    n_seg = -(-t_steps // seg)
    ring, _ = ja.ring_depth(20, 21, torch.float32, n_seg)
    shape = ja.scratch_shape(512, t_steps, seg, 20, 21, ring)
    assert shape == (512, ring, min(seg, t_steps), ja.scratch_stride(20, 21))
    assert ja.scratch_stride(20, 21) == 21 + 21 * 21 + 2 * 20 * 21 + 20 + 1
    # at most RING_MAX times the one-segment scratch of a kernel that
    # replays and sweeps in turn
    one = 512 * min(seg, t_steps) * ja.scratch_stride(20, 21)
    assert np.prod(shape) <= ja.RING_MAX * one
    assert ring <= max(1, n_seg)


@pytest.mark.parametrize("b,want", [(1, "WIDE"), (132, "WIDE"),
                                    (133, "COMPACT"), (512, "COMPACT")])
def test_k11_block_shape_spends_idle_sms_on_small_fleets(monkeypatch, b,
                                                         want):
    """The wide block while every block of it is resident at once (one
    a SM, 132 SMs), the compact one past that."""
    import contextlib
    import types

    ja = _k11_module()
    monkeypatch.setattr(ja, "occupancy", lambda *a, **k: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    got = ja.block_shape(b, 20, 21, torch.float32, 4, False, "cuda")
    assert got == getattr(ja, want)
    assert ja.COMPACT == (1, 4) and ja.WIDE == (2, 8)
    # a spilled layout always runs in the compact block
    assert ja.block_shape(b, 45, 46, torch.float64, 4, True,
                          "cuda") == ja.COMPACT
