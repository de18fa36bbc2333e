"""K1's warp kernel (``csrc/joint_warp_step.cuh``): its launch geometry
and shared-memory layout, mirrored in ``kernels/joint_filter.py``, held to
the sources; the oracle wrappers' refusals; the C signatures.  Pure
Python: the kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``), where the warp kernel is held to
the block kernel bit for bit."""

import contextlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from metran_tpu_torch.kernels import build
from metran_tpu_torch.kernels import joint_filter as jf
from metran_tpu_torch.ops import dfm_statespace

torch.set_num_threads(1)

CSRC = Path(jf.__file__).parent / "csrc"


def _source(name):
    return (CSRC / name).read_text()


def _layout_text():
    src = _source("joint_warp_step.cuh")
    body = src[src.index("__host__ __device__ inline size_t carve("):]
    return body[:body.index("return (c.used + 15) / 16 * 16;")]


def _taken(text, big_n, s, sp, lp):
    """What a run of ``c.take<U>(...)`` calls allocates at row strides
    ``sp`` and ``lp``: ``(values, words)``, values of the float type T
    and 32-bit words (``int``, ``uint32_t``)."""
    env = {"N": big_n, "S": s, "sp": sp, "lp": lp, "nw": (s + 31) // 32,
           "umax": max, "kMaxGroup": jf.MAX_GROUP}
    values = words = 0
    for kind, expr in re.findall(r"c\.take<(T|int|uint32_t)>\(([^;]+)\);",
                                 text):
        expr = expr.replace("(size_t)", "").replace("s->nw", "nw")
        count = eval(expr, {}, dict(env))
        if kind == "T":
            values += count
        else:
            words += count
    return values, words


def _source_model_bytes(big_n, s, item):
    """``jointw::layout`` evaluated from the source: the odd strides
    while they fit ``kMaxSmem``, else S and N."""
    def carve(sp, lp):
        values, words = _taken(_layout_text(), big_n, s, sp, lp)
        return -(-(values * item + 4 * words) // 16) * 16
    odd = carve(s | 1, big_n | 1)
    return odd if odd <= jf.MAX_SMEM else carve(s, big_n)


@pytest.mark.parametrize("big_n,s", [(20, 21), (24, 32), (40, 41), (45, 46),
                                     (1, 1), (5, 7), (90, 91), (88, 96),
                                     (64, 72), (16, 216), (7, 40)])
def test_model_bytes_mirror_the_sources_layout(big_n, s):
    values, words = _taken(_layout_text(), big_n, s, s | 1, big_n | 1)
    assert values and words
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        assert jf.model_bytes(big_n, s, dtype) == _source_model_bytes(
            big_n, s, item)
        assert jf.model_bytes(big_n, s, dtype) % 16 == 0
        assert jf.smem_bytes(big_n, s, dtype, 3) == 3 * jf.model_bytes(
            big_n, s, dtype)


def test_the_layout_drops_the_odd_strides_only_where_they_do_not_fit():
    # (16, 216) f32 fits only with the strides S and N
    odd = _taken(_layout_text(), 16, 216, 217, 17)
    assert 4 * odd[0] + 4 * odd[1] > jf.MAX_SMEM
    assert jf.model_bytes(16, 216, torch.float32) <= jf.MAX_SMEM
    flat = _taken(_layout_text(), 16, 216, 216, 16)
    assert jf.model_bytes(16, 216, torch.float32) == -(
        -(4 * flat[0] + 4 * flat[1]) // 16) * 16
    # the flagship keeps them
    odd = _taken(_layout_text(), 20, 21, 21, 21)
    assert jf.model_bytes(20, 21, torch.float32) == -(
        -(4 * odd[0] + 4 * odd[1]) // 16) * 16


def test_layout_constants_mirror_the_source():
    src = _source("joint_warp_step.cuh")
    assert int(re.search(r"constexpr int kMaxModels = (\d+);", src)[1]) \
        == jf.MAX_MODELS
    assert int(re.search(r"constexpr int kMaxGroup = (\d+);", src)[1]) \
        == jf.MAX_GROUP
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", src)[1]) \
        == jf.MAX_SMEM
    assert int(re.search(r"constexpr int kLanes = (\d+);", src)[1]) == 32
    assert "const size_t odd = carve<T>(raw, N, S, S | 1, N | 1, s);" in src
    assert "return odd <= kMaxSmem ? odd : carve<T>(raw, N, S, S, N, s);" \
        in src
    assert "s->nw = (S + 31) / 32;" in src
    # the factor and K F share one piece
    assert "s->Hm = s->L;" in src
    # the block kernel's layout (the arena's joint body) is unchanged
    step = _source("joint_step.cuh")
    assert ("return (size_t)S * S + 2 * (size_t)N * S + 2 * (size_t)N * N +"
            in step)
    assert jf.block_smem_bytes(20, 21, torch.float32) == 4 * (
        21 * 21 + 2 * 20 * 21 + 2 * 20 * 20 + 21 * 20 + 2 * 21 + 3 * 20)
    # the launch: W models a block, G warps a model (one or kMaxGroup),
    # W times one model's bytes
    cu = _source("joint_filter.cu")
    assert "W < 1 || W * G > jointw::kMaxModels" in cu
    assert "if (G == 1)" in cu and "if (G == jointw::kMaxGroup)" in cu
    assert "(size_t)W * jointw::model_bytes<T>(N, S)" in cu
    assert "<<<(B + W - 1) / W, W * kG * jointw::kLanes, smem," in cu
    # the occupancy query asks for the launch's own block
    assert "W * kG * jointw::kLanes, smem);" in cu
    step_modes = re.search(r"enum Mode \{ kCarry = (\d), kBounds = (\d), "
                           r"kStore = (\d) \};", step)
    assert jf.MODES == {"carry": int(step_modes[1]),
                        "bounds": int(step_modes[2]),
                        "store": int(step_modes[3])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_warp_layout_fits_the_flagship_and_serving_buckets(dtype):
    for big_n, s in ((20, 21), (24, 32)):  # flagship; its serving bucket
        assert jf.model_bytes(big_n, s, dtype) <= jf.MAX_SMEM
        assert jf.MAX_SMEM // jf.model_bytes(big_n, s, dtype) >= 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_warp_layout_fits_every_bucket_the_block_layout_fits(dtype):
    """Every (N, S) with N < S <= 256 that the block kernel (and the joint
    arena update, K16) takes, the warp kernel takes too, in no more bytes:
    the registry's buckets (multiples of 8) among them."""
    took = 0
    for big_n in range(1, 256):
        for s in range(big_n + 1, 257):
            block = jf.block_smem_bytes(big_n, s, dtype)
            if block <= jf.MAX_SMEM:
                took += 1
                assert jf.model_bytes(big_n, s, dtype) <= jf.MAX_SMEM, (
                    big_n, s)
    assert took > 1000


@pytest.mark.parametrize("dtype,big_n,s", [
    (torch.float32, 88, 96), (torch.float64, 64, 72),
    (torch.float32, 16, 216), (torch.float32, 80, 88),
    (torch.float64, 56, 64)])
def test_the_largest_multiple_of_8_buckets_fit_both_kernels(dtype, big_n,
                                                            s):
    assert jf.block_smem_bytes(big_n, s, dtype) <= jf.MAX_SMEM
    assert jf.model_bytes(big_n, s, dtype) <= jf.block_smem_bytes(
        big_n, s, dtype)


@pytest.mark.parametrize("dtype,largest,block_largest",
                         [(torch.float32, 106, 97), (torch.float64, 74, 68)])
def test_the_largest_one_factor_model_the_warp_layout_takes(
        dtype, largest, block_largest):
    """N series and one factor (S = N + 1): the warp kernel's one-model
    layout fits up to N = 106 in f32 and 74 in f64, the block kernel's up
    to 97 and 68 (the warp layout keeps the factor and K F in one piece
    and Z's nonzeros as bits)."""
    fits = [n for n in range(1, 200)
            if jf.model_bytes(n, n + 1, dtype) <= jf.MAX_SMEM]
    assert max(fits) == largest and fits == list(range(1, largest + 1))
    assert max(n for n in range(1, 200) if jf.block_smem_bytes(
        n, n + 1, dtype) <= jf.MAX_SMEM) == block_largest


def _props(monkeypatch, sms=132, blocks=16, one=None):
    """A card of ``sms`` SMs, each keeping ``blocks`` four-warp blocks
    resident, and ``one(W)`` one-warp blocks of W models (default: as
    many as keep 64 warps); records the occupancy queries."""
    asked = []

    def occupancy(n, s, dtype, mode, models, group):
        asked.append((n, s, dtype, mode, models, group))
        if group == jf.MAX_GROUP:
            return blocks
        return one(models) if one else 64 // models

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(jf, "occupancy", occupancy)
    return asked


@pytest.mark.parametrize("b,group", [(1, 4), (133, 4), (512, 4),
                                     (16 * 132, 4), (16 * 132 + 1, 1),
                                     (4096, 1), (100_000, 1)])
def test_block_shape_spends_warps_while_the_card_has_them(monkeypatch, b,
                                                          group):
    """Four warps a model while every four-warp block is resident (SMs
    times the occupancy calculator's blocks a SM), then a warp a model,
    the width asked of the calculator for each W that fits."""
    asked = _props(monkeypatch)
    w, g = jf.block_shape(b, 20, 21, torch.float32, "cuda", "bounds")
    assert g == group and 1 <= w * g <= jf.MAX_MODELS
    assert asked[0] == (20, 21, torch.float32, "bounds", 1, jf.MAX_GROUP)
    assert all(q[3] == "bounds" for q in asked)
    if group == 1:
        assert [q[4] for q in asked[1:]] == list(range(1, 9))
        assert {q[5] for q in asked[1:]} == {1}
    else:
        assert len(asked) == 1


@pytest.mark.parametrize("blocks", [9, 4, 1])
def test_block_shape_follows_the_occupancy_not_the_warp_count(monkeypatch,
                                                              blocks):
    """Registers or shared memory may hold fewer than 16 four-warp blocks
    a SM: the switch moves with what the calculator reports."""
    _props(monkeypatch, blocks=blocks)
    edge = blocks * 132
    for dtype in (torch.float32, torch.float64):
        assert jf.block_shape(edge, 20, 21, dtype, "cuda") == (1, 4)
        assert jf.block_shape(edge + 1, 20, 21, dtype, "cuda")[1] == 1


@pytest.mark.parametrize("dtype,b,want", [
    (torch.float64, 1_024, (8, 1)), (torch.float64, 1_536, (6, 1)),
    (torch.float64, 2_048, (8, 1)), (torch.float64, 4_096, (4, 1)),
    (torch.float32, 1_024, (8, 1)), (torch.float32, 1_536, (6, 1)),
    (torch.float32, 2_048, (8, 1)), (torch.float32, 4_096, (8, 1))])
def test_block_shape_takes_the_fewest_waves_then_the_lightest_sm(
        monkeypatch, dtype, b, want):
    """One-warp blocks limited by registers (16 warps a SM) and by 228 KiB
    of shared memory a SM (1 KiB reserved a block), as on an H100 at
    (20, 21): f64 keeps 12 models a SM at W = 1, 2, 3, 4 and 6 but 8 at
    W = 8; f32 16 at W = 1, 2, 4 and 8.  1,536 f64 models fit one wave at
    W = 6 and need two at W = 8; 2,048 need two either way, with 16
    models on the busiest SM at W = 8 and 18 at W = 6; 4,096 need three
    waves at W = 4 and four at W = 8."""
    mb = jf.model_bytes(20, 21, dtype)
    _props(monkeypatch, blocks=4,
           one=lambda w: min(32, 16 // w, 233_472 // (w * mb + 1_024)))
    assert jf.block_shape(b, 20, 21, dtype, "cuda") == want


def test_block_shape_past_residency_takes_what_shared_memory_holds(
        monkeypatch):
    _props(monkeypatch)
    b = 16 * 132 + 1
    # f64 (45, 46): 86,448 bytes a model, so two a block at most
    assert jf.model_bytes(45, 46, torch.float64) == 86_448
    asked = _props(monkeypatch)
    assert jf.block_shape(b, 45, 46, torch.float64, "cuda")[1] == 1
    assert [q[4] for q in asked[1:]] == [1, 2]
    # a model that only fits alone
    assert jf.block_shape(b, 70, 71, torch.float64, "cuda") == (1, 1)
    for big_n in (1, 20, 24, 40, 70):
        for dtype in (torch.float32, torch.float64):
            for bb in (1, b):
                w, g = jf.block_shape(bb, big_n, big_n + 1, dtype, "cuda")
                assert 1 <= w and w * g <= jf.MAX_MODELS
                assert g in (1, jf.MAX_GROUP)
                assert jf.smem_bytes(big_n, big_n + 1, dtype, w) <= \
                    jf.MAX_SMEM


def _args(b=2, k=3, n=5, kf=1, dtype=torch.float64):
    rng = np.random.default_rng(0)
    phi, q, z, r = dfm_statespace(rng.uniform(5, 40, (b, n)),
                                  rng.uniform(10, 60, (b, kf)),
                                  rng.uniform(0.3, 0.8, (b, n, kf)), 1.0,
                                  device="cpu", dtype=dtype)
    s = n + kf
    return (phi, q, z, r, torch.zeros(b, s, dtype=dtype),
            torch.eye(s, dtype=dtype).expand(b, s, s).contiguous(),
            torch.zeros(b, k, n, dtype=dtype),
            torch.ones(b, k, n, dtype=torch.bool))


@pytest.mark.parametrize("fn", ["joint_filter_append_block",
                                "joint_filter_store_block",
                                "joint_filter_append_kernel",
                                "joint_filter_store_kernel"])
def test_kernel_and_oracle_wrappers_refuse_cpu_tensors(fn):
    before = build.launches(), build.oracle_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(jf, fn)(*_args())
    assert (build.launches(), build.oracle_launches()) == before


def test_a_bucket_past_shared_memory_raises_before_anything_runs():
    args = _args(b=1, k=1, n=76, kf=1)  # f64 (76, 77): past N = 74
    with pytest.raises(ValueError, match="shared memory"):
        jf.joint_filter_append_kernel(*args)
    with pytest.raises(ValueError, match="shared memory"):
        jf.joint_filter_store_kernel(*args)
    # nor the block kernel (N = 68 at most)
    with pytest.raises(ValueError, match="shared memory"):
        jf.joint_filter_append_block(*args)
    # the block kernel's largest one-factor bucket passes the warp
    # kernel's check, and stops only at the tensors' device
    widest = _args(b=1, k=1, n=68, kf=1)
    for fn in (jf.joint_filter_append_kernel, jf.joint_filter_append_block):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*widest)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    args = _args()
    before = build.launches()
    got = jf.joint_filter_append(*args, bounds_seg=2)
    want = jf.joint_filter_append_plain(*args, bounds_seg=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = jf.joint_filter_store(*args)
    want = jf.joint_filter_store_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.launches() == before


def _c_entries():
    """``{name: [ctypes type, ...]}`` of the extern "C" functions in
    ``joint_filter.cu``, from their parameter lists."""
    src = _source("joint_filter.cu")
    src = src[src.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"\nint (metran_\w+)\(([^)]*)\)", src):
        types_ = []
        for p in params.split(","):
            p = " ".join(p.split())
            types_.append(build._PTR if "*" in p else build._INT)
        out[name] = types_
    return out


def test_the_c_signatures_are_the_bindings():
    entries = _c_entries()
    sigs = dict(build._SIGNATURES["joint_filter"])
    assert set(sigs) == {"metran_joint_filter", "metran_joint_filter_store",
                         "metran_joint_filter_block",
                         "metran_joint_filter_store_block",
                         "metran_joint_filter_model_bytes",
                         "metran_joint_filter_occupancy"}
    for base, argtypes in sigs.items():
        for suffix in ("f32", "f64"):
            assert entries[f"{base}_{suffix}"] == argtypes, base
    # the warp entries take W and G after the block entries' integers
    assert sigs["metran_joint_filter"] == \
        sigs["metran_joint_filter_block"][:-1] + [build._INT] * 2 + [
            build._PTR]
    assert sigs["metran_joint_filter_store"] == \
        sigs["metran_joint_filter_store_block"][:-1] + [build._INT] * 2 + [
            build._PTR]


def test_the_oracle_counts_its_launches_apart(monkeypatch):
    """The block kernel's launches go to their own counters, which the
    path counters' reset leaves alone; the warp kernel keeps K1's names."""
    assert {"joint_filter_append", "joint_filter_store"} <= set(
        build.LAUNCHES)
    assert set(build.ORACLE_LAUNCHES) == {"joint_filter_append_block",
                                          "joint_filter_store_block",
                                          "sqrt_filter_block",
                                          "sqrt_filter_gated_block",
                                          "sqrt_filter_robust_block",
                                          "lanes_adjoint_warp",
                                          "lanes_filter_warp"}
    assert not set(build.ORACLE_LAUNCHES) & set(build.LAUNCHES)
    monkeypatch.setattr(build, "ORACLE_LAUNCHES",
                        dict.fromkeys(build.ORACLE_LAUNCHES, 0))
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    build.count_launch("joint_filter_append_block")
    build.count_launch("joint_filter_append")
    assert build.oracle_launches()["joint_filter_append_block"] == 1
    assert build.launches()["joint_filter_append"] == 1
    build.reset_launches()
    assert build.oracle_launches()["joint_filter_append_block"] == 1
    assert set(build.launches().values()) == {0}
