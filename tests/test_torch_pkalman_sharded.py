"""The sequence-sharded associative scan (``metran_tpu_torch.ops.
pkalman.sequence_sharded_filter``, kernels K19/K20 in their ``total``,
``carry`` and ``prefix`` modes, here their plain versions) against
``metran_tpu.ops.sequence_sharded_filter`` on the CPU, f64.

At the JAX test's shape (5 series, 2 factors, T = 120, 30% missing, 8
shards; ``tests/test_pkalman.py``): the port's sharded filter and
smoother within 1e-10 abs of JAX's sharded ones, which run in a fresh
interpreter (XLA:CPU has crashed compiling them late in a long pytest
process; ``conftest.run_python_subprocess``), and the deviance from their
``sigma``/``detf`` within rtol 1e-10; in-process, the same values against
the port's unsharded ``parallel_filter``/``parallel_smoother`` and JAX's.
The modes' plain versions compose to the unsharded plain scan bit for bit
on uneven chunks, a 2-D mesh computes each shard once, and a time axis the
mesh does not divide raises JAX's error.
"""

import numpy as np
import pytest
import torch
from conftest import random_ssm, run_python_subprocess

from metran_tpu import ops as jops
from metran_tpu_torch.kernels import pkalman as kpk
from metran_tpu_torch.ops import deviance_terms
from metran_tpu_torch.ops import pkalman as pops
from metran_tpu_torch.ops.statespace import StateSpace
from metran_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.shard

torch.set_num_threads(1)

FIELDS = ("mean_p", "cov_p", "mean_f", "cov_f", "sigma", "detf", "mean_s",
          "cov_s")


def _case():
    """The JAX test's inputs (``check_sequence_sharded_matches_unsharded``)."""
    rng = np.random.default_rng(7)
    ss, y, mask = random_ssm(rng, n_series=5, n_factors=2, t=120,
                             missing=0.3)
    t = (y.shape[0] // 8) * 8
    return ss, y[:t], mask[:t]


def _port(ss):
    return StateSpace(*(torch.as_tensor(np.array(leaf)) for leaf in ss))


def _mesh(n, axes=("seq",)):
    return make_mesh(n, axes, devices=["cpu"] * n)


def _flat(filt, smooth):
    return dict(zip(FIELDS, [np.asarray(x) for x in (*filt, *smooth)]))


def _deviance(sigma, detf, mask):
    return float(deviance_terms(torch.as_tensor(sigma), torch.as_tensor(
        detf), torch.as_tensor(mask), warmup=1))


@pytest.fixture(scope="module")
def sharded():
    ss, y, mask = _case()
    filt, smooth = pops.sequence_sharded_filter(_port(ss), y, mask, _mesh(8))
    return _flat(filt, smooth)


def test_sharded_scan_matches_jax_sharded_scan(sharded, tmp_path):
    out = tmp_path / "jax_sharded.npz"
    res = run_python_subprocess(f"""
import numpy as np
import jax
from jax.sharding import Mesh
from tests.conftest import random_ssm
from metran_tpu.ops import sequence_sharded_filter
ss, y, mask = random_ssm(np.random.default_rng(7), n_series=5, n_factors=2,
                         t=120, missing=0.3)
mesh = Mesh(np.array(jax.devices()[:8]), ("seq",))
filt, smooth = sequence_sharded_filter(ss, y, mask, mesh, axis="seq")
np.savez({str(out)!r}, **dict(zip({FIELDS!r}, [
    np.asarray(x) for x in (*filt, *smooth)])))
print("JAX_SHARDED_OK")
""")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "JAX_SHARDED_OK" in res.stdout
    want = dict(np.load(out))
    for key in ("mean_f", "cov_f", "mean_s", "cov_s", "mean_p", "cov_p"):
        np.testing.assert_allclose(sharded[key], want[key], rtol=0,
                                   atol=1e-10, err_msg=key)
    _, _, mask = _case()
    got = _deviance(sharded["sigma"], sharded["detf"], mask)
    ref = _deviance(want["sigma"], want["detf"], mask)
    assert got == pytest.approx(ref, rel=1e-10)


def test_sharded_scan_matches_the_unsharded_engines(sharded):
    ss, y, mask = _case()
    pss = _port(ss)
    pf = pops.parallel_filter(pss, y, mask, device="cpu")
    ps = pops.parallel_smoother(pss, pf)
    jf = jops.parallel_filter(ss, y, mask)
    js = jops.parallel_smoother(ss, jf)
    for ref in (_flat(pf, ps), _flat(jf, js)):
        for key in ("mean_f", "cov_f", "mean_s", "cov_s"):
            np.testing.assert_allclose(sharded[key], ref[key], rtol=0,
                                       atol=1e-10, err_msg=key)
        assert _deviance(sharded["sigma"], sharded["detf"], mask) == \
            pytest.approx(_deviance(ref["sigma"], ref["detf"], mask),
                          rel=1e-10)


@pytest.mark.parametrize("block", [None, 4, "auto"])
def test_every_block_and_a_2d_mesh_agree(sharded, block):
    """``block`` resolves against the per-shard length (15 steps: one
    chunk, chunks of 4 with a ragged 3, the automatic length); a 2-D mesh
    shards over its ``"seq"`` axis only."""
    ss, y, mask = _case()
    filt, smooth = pops.sequence_sharded_filter(_port(ss), y, mask, _mesh(8),
                                                block=block)
    got = _flat(filt, smooth)
    for key in FIELDS:
        np.testing.assert_allclose(got[key], sharded[key], rtol=1e-10,
                                   atol=1e-10, err_msg=key)
    mesh2 = _mesh(8, ("batch", "seq"))
    assert mesh2.shape == {"batch": 4, "seq": 2}
    filt, smooth = pops.sequence_sharded_filter(_port(ss), y, mask, mesh2,
                                                block=block)
    for key, val in _flat(filt, smooth).items():
        np.testing.assert_allclose(val, sharded[key], rtol=1e-10,
                                   atol=1e-10, err_msg=key)


def test_time_axis_not_divisible_raises_jax_error():
    ss, y, mask = _case()
    with pytest.raises(ValueError, match=r"time axis \(119\) must be "
                       r"divisible by mesh axis 'seq' \(8\)"):
        pops.sequence_sharded_filter(_port(ss), y[:119], mask[:119],
                                     _mesh(8))


@pytest.mark.parametrize("chunk", [7, 4, 1])
def test_mode_plain_versions_compose_to_the_unsharded_scan(chunk):
    """Uneven chunks: ``prefix`` from the origin (no incoming moment) over
    ``total``'s chunk totals is the unsharded plain scan bit for bit, the
    total's moment part is the last step's filtered (smoothed) moment, and
    ``carry`` over two shards' totals gives the second shard's incoming
    moment, from which its ``prefix`` continues the unsharded scan."""
    ss, y, mask = _case()
    pss = _port(ss)
    phi, q, z, r = (leaf[None].contiguous() for leaf in pss)
    yb, mb = torch.as_tensor(y)[None], torch.as_tensor(mask)[None]
    n = phi.shape[-1]
    shapes = kpk.filter_parts(n)
    full = kpk.parallel_filter_plain(phi, q, z, r, yb, mb, chunk)
    total, tot = kpk.parallel_filter_total_plain(phi, q, z, r, yb, mb,
                                                 chunk)
    assert tot.shape == (1, kpk.n_chunks(120, chunk), total.shape[-1])
    got = kpk.parallel_filter_prefix_plain(phi, q, z, r, yb, mb, chunk, tot)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    _, b_tot, c_tot, _, _ = kpk.unpack_parts(total, shapes)
    torch.testing.assert_close(b_tot, full[2][:, -1], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(c_tot, full[3][:, -1], rtol=1e-12,
                               atol=1e-12)
    # two shards of 60: the second continues from the carry
    halves = [slice(0, 60), slice(60, 120)]
    tots = [kpk.parallel_filter_total_plain(phi, q, z, r, yb[:, h], mb[:, h],
                                            chunk, origin=k == 0)
            for k, h in enumerate(halves)]
    pre = kpk.parallel_filter_carry_plain(
        torch.stack([t[0] for t in tots], dim=1), n)
    assert pre.shape == (1, 1, n * n + n)
    second = kpk.parallel_filter_prefix_plain(
        phi, q, z, r, yb[:, 60:], mb[:, 60:], chunk, tots[1][1], pre[:, 0])
    for a, b in zip(second, full):
        torch.testing.assert_close(a, b[:, 60:], rtol=1e-10, atol=1e-10)
    # the smoother: prefix from the series' last step is K20's plain scan
    sfull = kpk.parallel_smooth_plain(phi, full[2], full[3], full[0],
                                      full[1], chunk)
    stotal, stot = kpk.parallel_smooth_total_plain(
        phi, full[2], full[3], full[0], full[1], chunk)
    sgot = kpk.parallel_smooth_prefix_plain(phi, full[2], full[3], full[0],
                                            full[1], chunk, stot)
    assert torch.equal(sgot[0], sfull[0]) and torch.equal(sgot[1], sfull[1])
    _, g_tot, l_tot = kpk.unpack_parts(stotal, kpk.smoother_parts(n))
    torch.testing.assert_close(g_tot, sfull[0][:, 0], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(l_tot, sfull[1][:, 0], rtol=1e-12,
                               atol=1e-12)


def test_mode_wrappers_check_their_inputs():
    ss, y, mask = _case()
    phi, q, z, r = (leaf[None].contiguous() for leaf in _port(ss))
    yb, mb = torch.as_tensor(y)[None], torch.as_tensor(mask)[None]
    total, tot = kpk.parallel_filter_total(phi, q, z, r, yb, mb, 8)
    with pytest.raises(ValueError, match="chunk_totals"):
        kpk.parallel_filter_prefix(phi, q, z, r, yb, mb, 7, tot)
    with pytest.raises(ValueError, match="incoming"):
        kpk.parallel_filter_prefix(phi, q, z, r, yb, mb, 8, tot,
                                   incoming=total)
    f = kpk.parallel_filter(phi, q, z, r, yb, mb, 8)
    halo = (f[0][:, 0], f[1][:, 0])
    _, stot = kpk.parallel_smooth_total(phi, f[2], f[3], f[0], f[1], 8)
    with pytest.raises(ValueError, match="halo"):
        kpk.parallel_smooth_prefix(phi, f[2], f[3], f[0], f[1], 8, stot,
                                   halo=halo)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.parallel_filter_total_kernel(phi, q, z, r, yb, mb, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kpk.parallel_smooth_carry_kernel(stot, phi.shape[-1])
