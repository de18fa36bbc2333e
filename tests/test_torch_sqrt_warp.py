"""K9's group kernel (``csrc/sqrt_warp_step.cuh``): its launch geometry
and shared-memory layout, mirrored in ``kernels/sqrt_filter.py``, held to
the sources; the oracle wrappers' refusals; the C signatures.  Pure
Python: the kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``), where the group kernel is held to
the block kernel bit for bit."""

import contextlib
import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from metran_tpu_torch.kernels import build

sf = importlib.import_module("metran_tpu_torch.kernels.sqrt_filter")

torch.set_num_threads(1)

CSRC = Path(sf.__file__).parent / "csrc"


def _source(name):
    return (CSRC / name).read_text()


def _layout_text():
    src = _source("sqrt_warp_step.cuh")
    body = src[src.index("__host__ __device__ inline size_t carve("):]
    return body[:body.index("return (c.used + 15) / 16 * 16;")]


def _flags():
    """The enumerators of ``sqrtw::Flag`` before ``kFlags``."""
    src = _source("sqrt_warp_step.cuh")
    names = re.search(r"enum Flag \{([^}]*)\};", src)[1]
    names = [x.split("=")[0].strip() for x in names.split(",")]
    return names[:names.index("kFlags")]


def _taken(text, big_n, n, odd, bits):
    """What a run of ``c.take<U>(...)`` calls allocates with odd leading
    dimensions (or not) and Z's bits (or not): ``(values, words)``, values
    of the float type T and 32-bit words (``int``, ``uint32_t``)."""
    r = big_n + n
    env = {"N": big_n, "n": n, "R": r, "umax": max,
           "ldu": (r | 1) if odd else r, "kFlags": len(_flags()),
           "nw": (n + 31) // 32 if bits else 0}
    env["ldp"] = (2 * n | 1) if odd else 2 * n
    values = words = 0
    for line in text.splitlines():
        m = re.search(r"c\.take<(T|int|uint32_t)>\(", line)
        if m is None:
            continue
        if "bits ?" in line and not bits:
            continue
        depth, end = 1, m.end()
        while depth:  # the call's balanced argument
            depth += {"(": 1, ")": -1}.get(line[end], 0)
            end += 1
        expr = (line[m.end():end - 1].replace("(size_t)", "")
                .replace("s->ldp", "ldp").replace("s->nw", "nw"))
        count = eval(expr, {}, dict(env))
        if m[1] == "T":
            values += count
        else:
            words += count
    return values, words


def _source_model_bytes(big_n, n, item):
    """``sqrtw::layout`` evaluated from the source: the odd leading
    dimensions and the bits while they fit ``kMaxSmem``, else neither."""
    def carve(odd, bits):
        values, words = _taken(_layout_text(), big_n, n, odd, bits)
        return -(-(values * item + 4 * words) // 16) * 16
    full = carve(True, True)
    return full if full <= sf.MAX_SMEM else carve(False, False)


@pytest.mark.parametrize("big_n,n", [(20, 21), (24, 32), (40, 41), (45, 46),
                                     (1, 2), (5, 7), (78, 80), (60, 87),
                                     (73, 82), (16, 216), (7, 40), (53, 57)])
def test_model_bytes_mirror_the_sources_layout(big_n, n):
    values, words = _taken(_layout_text(), big_n, n, True, True)
    assert values and words
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        assert sf.model_bytes(big_n, n, dtype) == _source_model_bytes(
            big_n, n, item)
        assert sf.model_bytes(big_n, n, dtype) % 16 == 0
        assert sf.smem_bytes(big_n, n, dtype, 3) == 3 * sf.model_bytes(
            big_n, n, dtype)


def test_the_layout_drops_the_odd_strides_and_bits_only_where_they_do_not_fit():
    # (73, 82) f32: the block kernel takes it, the full layout does not fit
    full = _taken(_layout_text(), 73, 82, True, True)
    assert 4 * full[0] + 4 * full[1] > sf.MAX_SMEM
    assert sf.block_smem_bytes(73, 82, torch.float32) <= sf.MAX_SMEM
    flat = _taken(_layout_text(), 73, 82, False, False)
    assert sf.model_bytes(73, 82, torch.float32) == -(
        -(4 * flat[0] + 4 * flat[1]) // 16) * 16 <= sf.MAX_SMEM
    # the flagship keeps both
    full = _taken(_layout_text(), 20, 21, True, True)
    assert sf.model_bytes(20, 21, torch.float32) == -(
        -(4 * full[0] + 4 * full[1]) // 16) * 16


def test_layout_constants_mirror_the_source():
    src = _source("sqrt_warp_step.cuh")
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);", src)[1]) \
        == sf.MAX_WARPS
    assert int(re.search(r"constexpr int kMaxGroup = (\d+);", src)[1]) \
        == sf.MAX_GROUP
    assert int(re.search(r"constexpr int kMinGroup = (\d+);", src)[1]) \
        == sf.MIN_GROUP
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", src)[1]) \
        == sf.MAX_SMEM
    assert int(re.search(r"constexpr int kLanes = (\d+);", src)[1]) == 32
    assert len(_flags()) == sf._FLAGS
    assert ("const size_t full = carve<T>(raw, N, n, true, true, s);"
            in src)
    assert ("return full <= kMaxSmem ? full : carve<T>(raw, N, n, false, "
            "false, s);" in src)
    # the predict array also holds the gated rows of Z S_p and the update
    # QR's reflectors; the update array the predict QR's reflectors
    assert "T* zsp = s.pa;" in src
    assert "T* tau_u = s.pa + (size_t)N * n;" in src
    assert "s.dg, s.ua, s.ua + n," in src
    # the block kernel's layout (the square-root arena's body) is unchanged
    step = _source("sqrt_step.cuh")
    assert "(size_t)ldu * (N + n), (size_t)(N + n), (size_t)N, (size_t)N," \
        in step
    # the launch: W lanes a block, G warps a lane (one or kMaxGroup), W
    # times one lane's bytes, the occupancy query for the launch's block
    cu = _source("sqrt_filter.cu")
    assert "W < 1 || W * G > sqrtw::kMaxWarps" in cu
    assert "if (G == sqrtw::kMinGroup)" in cu
    assert "if (G == sqrtw::kMaxGroup)" in cu
    assert "(size_t)W * sqrtw::model_bytes<T>(N, n)" in cu
    assert "<<<(L + W - 1) / W, W * kG * sqrtw::kLanes, smem," in cu
    assert "W * kG * sqrtw::kLanes, smem);" in cu
    occ = cu[cu.index("int occupancy(int N, int n, int variant"):]
    cases = dict(re.findall(r"case (\d): METRAN_SQRT_OCC\(([^)]*)\)", occ))
    gates = {"kReject": "reject", "kHuber": "huber", "kInflate": "inflate",
             "kRobust + imap::kCensored": "censored",
             "kRobust + imap::kQuantized": "quantized",
             "kRobust + imap::kHuberT": "huber_t"}
    named = {}
    for code, args in cases.items():
        store, bounds, gate = [a.strip() for a in args.split(",", 2)]
        named[int(code)] = (gates[gate] if gate != "kNoGate"
                            else "store" if store == "true"
                            else "bounds" if bounds == "true" else "carry")
    assert named == {v: k for k, v in sf.VARIANTS.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_group_layout_fits_the_flagship_and_serving_buckets(dtype):
    for big_n, n in ((20, 21), (24, 32)):  # flagship; its serving bucket
        assert sf.model_bytes(big_n, n, dtype) <= sf.MAX_SMEM
        assert sf.MAX_SMEM // sf.model_bytes(big_n, n, dtype) >= 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_group_layout_fits_every_bucket_the_block_layout_fits(dtype):
    """Every (N, n) with N < n <= 256 that the block kernel (and the
    square-root arena update, K16) takes, the group kernel takes too: the
    registry's buckets (multiples of 8) among them."""
    took = 0
    for big_n in range(1, 256):
        for n in range(big_n + 1, 257):
            if sf.block_smem_bytes(big_n, n, dtype) <= sf.MAX_SMEM:
                took += 1
                assert sf.model_bytes(big_n, n, dtype) <= sf.MAX_SMEM, (
                    big_n, n)
    assert took > 2000


@pytest.mark.parametrize("dtype,big_n,n", [
    (torch.float32, 72, 80), (torch.float32, 56, 88), (torch.float32, 8, 104),
    (torch.float64, 48, 56), (torch.float64, 32, 64), (torch.float64, 8, 72)])
def test_the_largest_multiple_of_8_buckets_fit_both_kernels(dtype, big_n,
                                                            n):
    assert sf.block_smem_bytes(big_n, n, dtype) <= sf.MAX_SMEM
    assert sf.model_bytes(big_n, n, dtype) <= sf.MAX_SMEM


def _props(monkeypatch, sms=132, blocks=8, two=None):
    """A card of ``sms`` SMs, each keeping ``blocks`` four-warp blocks
    resident, and ``two(W)`` two-warp blocks of W lanes (default: as many
    as keep 64 warps); records the occupancy queries."""
    asked = []

    def occupancy(n, s, dtype, variant, models, group):
        asked.append((n, s, dtype, variant, models, group))
        if group == sf.MAX_GROUP:
            return blocks
        return two(models) if two else 32 // models

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(sf, "occupancy", occupancy)
    return asked


@pytest.mark.parametrize("b,group", [(1, 4), (133, 4), (512, 4),
                                     (8 * 132, 4), (8 * 132 + 1, 2),
                                     (4096, 2), (100_000, 2)])
def test_launch_shape_spends_warps_while_the_card_has_them(monkeypatch, b,
                                                           group):
    """Four warps a lane while every four-warp block is resident (SMs
    times the occupancy calculator's blocks a SM), then two warps a lane,
    the width asked of the calculator for each W that fits."""
    asked = _props(monkeypatch)
    w, g = sf.launch_shape(b, 20, 21, torch.float32, "cuda", "bounds")
    assert g == group and 1 <= w * g <= sf.MAX_WARPS
    assert asked[0] == (20, 21, torch.float32, "bounds", 1, sf.MAX_GROUP)
    assert all(q[3] == "bounds" for q in asked)
    if group == sf.MIN_GROUP:
        assert [q[4] for q in asked[1:]] == list(range(1, 5))
        assert {q[5] for q in asked[1:]} == {sf.MIN_GROUP}
    else:
        assert len(asked) == 1


@pytest.mark.parametrize("blocks", [13, 4, 1])
def test_launch_shape_follows_the_occupancy_not_the_warp_count(monkeypatch,
                                                               blocks):
    _props(monkeypatch, blocks=blocks)
    edge = blocks * 132
    for dtype in (torch.float32, torch.float64):
        for variant in sf.VARIANTS:
            assert sf.launch_shape(edge, 20, 21, dtype, "cuda",
                                   variant) == (1, 4)
            assert sf.launch_shape(edge + 1, 20, 21, dtype, "cuda",
                                   variant)[1] == sf.MIN_GROUP


@pytest.mark.parametrize("b,want", [(792, (3, 2)), (1_000, (4, 2)),
                                    (4_096, (2, 2))])
def test_launch_shape_takes_the_fewest_waves_then_the_lightest_sm(
        monkeypatch, b, want):
    """Two-warp blocks of W lanes resident 6, 3, 2 and 1 to a SM (6, 6, 6
    and 4 lanes, as registers and shared memory would allow): 792 lanes
    fit one wave at W = 1, 2 and 3 (the widest wins) and need two at W =
    4; 1,000 need two waves at every W, with 8 lanes on the busiest SM at
    W = 1, 2 and 4 and 9 at W = 3; 4,096 need six waves at W = 1, 2 and 3
    (33 lanes on the busiest SM at W = 3) and eight at W = 4."""
    _props(monkeypatch, blocks=1,
           two=lambda w: {1: 6, 2: 3, 3: 2, 4: 1}[w])
    assert sf.MAX_SMEM // sf.model_bytes(20, 21, torch.float32) >= 4
    assert sf.launch_shape(b, 20, 21, torch.float32, "cuda") == want


def test_launch_shape_past_residency_takes_what_shared_memory_holds(
        monkeypatch):
    _props(monkeypatch)
    b = 8 * 132 + 1
    # f32 (45, 46): two lanes a block at most
    mb = sf.model_bytes(45, 46, torch.float32)
    assert 2 * mb <= sf.MAX_SMEM < 3 * mb
    asked = _props(monkeypatch)
    assert sf.launch_shape(b, 45, 46, torch.float32, "cuda")[1] == \
        sf.MIN_GROUP
    assert [q[4] for q in asked[1:]] == [1, 2]
    # a lane that only fits alone
    assert sf.launch_shape(b, 45, 46, torch.float64, "cuda") == (
        1, sf.MIN_GROUP)
    for big_n in (1, 20, 24, 40, 50):
        for dtype in (torch.float32, torch.float64):
            for bb in (1, b):
                w, g = sf.launch_shape(bb, big_n, big_n + 1, dtype, "cuda")
                assert 1 <= w and w * g <= sf.MAX_WARPS
                assert g in (sf.MIN_GROUP, sf.MAX_GROUP)
                assert sf.smem_bytes(big_n, big_n + 1, dtype, w) <= \
                    sf.MAX_SMEM


def _lanes(b=2, t=3, big_n=4, kf=1, dtype=torch.float64):
    rng = np.random.default_rng(0)
    n = big_n + kf
    phi = torch.as_tensor(rng.uniform(0.5, 0.95, (n, b)), dtype=dtype)
    q = torch.as_tensor(rng.uniform(0.1, 1.0, (n, b)), dtype=dtype)
    z = torch.zeros((big_n, n, b), dtype=dtype)
    z[:, :big_n] = torch.eye(big_n, dtype=dtype)[..., None]
    z[:, big_n:] = torch.as_tensor(rng.uniform(0.3, 0.8, (big_n, kf, b)),
                                   dtype=dtype)
    r = torch.full((big_n, b), 0.2, dtype=dtype)
    y = torch.as_tensor(rng.normal(size=(b, t, big_n)), dtype=dtype)
    mask = torch.as_tensor(rng.uniform(size=(b, t, big_n)) > 0.3)
    lane_map = torch.arange(b, dtype=torch.int32)
    mean0 = torch.as_tensor(rng.normal(size=(b, n)), dtype=dtype)
    chol0 = torch.eye(n, dtype=dtype).expand(b, n, n).contiguous()
    return (phi, q, z, r, y, mask, lane_map), mean0, chol0


def _calls(args, mean0, chol0):
    """Every K9 entry of one kind (the group kernel's or the oracle's) on
    ``args``: ``{name: call(fn_module_name_suffix)}``."""
    b, big_n = args[0].shape[1], args[2].shape[0]
    armed = torch.ones(b, dtype=torch.bool)
    par = [torch.full((b, big_n), v, dtype=args[0].dtype)
           for v in (-0.5, 0.5, 0.1, 0.5)]
    return {
        "sqrt_filter": lambda fn: fn(*args, store=True),
        "sqrt_filter_gated": lambda fn: fn(*args[:6], mean0, chol0, armed,
                                           "reject", 4.0, args[6]),
        "sqrt_filter_robust": lambda fn: fn(*args[:6], mean0, chol0, armed,
                                            *par, "censored", 4.0,
                                            args[6]),
    }


@pytest.mark.parametrize("suffix", ["_kernel", "_block"])
@pytest.mark.parametrize("name", ["sqrt_filter", "sqrt_filter_gated",
                                  "sqrt_filter_robust"])
def test_kernel_and_oracle_wrappers_refuse_cpu_tensors(name, suffix):
    args, mean0, chol0 = _lanes()
    before = build.launches(), build.oracle_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _calls(args, mean0, chol0)[name](getattr(sf, name + suffix))
    assert (build.launches(), build.oracle_launches()) == before


def test_a_bucket_past_shared_memory_raises_before_anything_runs():
    # f64 (60, 61): past what either kernel takes
    args, mean0, chol0 = _lanes(b=1, t=1, big_n=60, kf=1)
    assert sf.block_smem_bytes(60, 61, torch.float64) > sf.MAX_SMEM
    assert sf.model_bytes(60, 61, torch.float64) > sf.MAX_SMEM
    for name, call in _calls(args, mean0, chol0).items():
        for suffix in ("_kernel", "_block"):
            with pytest.raises(ValueError, match="shared memory"):
                call(getattr(sf, name + suffix))
    # the block kernel's largest one-factor bucket passes the group
    # kernel's check, and stops only at the tensors' device
    widest = max(m for m in range(1, 80) if sf.block_smem_bytes(
        m, m + 1, torch.float64) + sf.BLOCK_STATIC_SMEM <= sf.MAX_SMEM)
    args, mean0, chol0 = _lanes(b=1, t=1, big_n=widest, kf=1)
    for suffix in ("_kernel", "_block"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            getattr(sf, "sqrt_filter" + suffix)(*args)


def test_the_block_kernels_static_shared_memory_is_counted():
    """f64 (35, 64): the block kernel's dynamic layout fits by 16 bytes,
    its four shared scalars do not, so its wrapper refuses the bucket
    before anything runs; the group kernel (no static shared memory)
    takes it."""
    src = _source("sqrt_step.cuh")
    assert "__shared__ int mo, bad;" in src
    assert "__shared__ T step_sigma, step_detf;" in src
    assert 2 * 4 + 2 * 8 <= sf.BLOCK_STATIC_SMEM
    assert sf.block_smem_bytes(35, 64, torch.float64) <= sf.MAX_SMEM
    assert sf.model_bytes(35, 64, torch.float64) <= sf.MAX_SMEM
    args, mean0, chol0 = _lanes(b=1, t=1, big_n=35, kf=29)
    with pytest.raises(ValueError, match="shared memory"):
        sf.sqrt_filter_block(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sf.sqrt_filter_kernel(*args)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    args, mean0, chol0 = _lanes()
    before = build.launches(), build.oracle_launches()
    for kw in ({}, {"store": True}, {"bounds_seg": 2},
               {"mean0": mean0, "chol0": chol0}):
        got = sf.sqrt_filter(*args, **kw)
        want = sf.sqrt_filter_plain(*args, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    b = args[0].shape[1]
    armed = torch.ones(b, dtype=torch.bool)
    got = sf.sqrt_filter_gated(*args[:6], mean0, chol0, armed, "huber", 1.0,
                               args[6])
    want = sf.sqrt_filter_gated_plain(*args[:6], mean0, chol0, armed,
                                      "huber", 1.0, args[6])
    assert all(torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))
               and torch.equal(g.isnan(), w.isnan())
               for g, w in zip(got, want))
    assert (build.launches(), build.oracle_launches()) == before


def _c_entries(name):
    """``{name: [ctypes type, ...]}`` of the extern "C" functions in
    ``csrc/<name>.cu``, from their parameter lists."""
    src = _source(f"{name}.cu")
    src = src[src.index('extern "C" {'):]
    out = {}
    for entry, params in re.findall(r"\nint (metran_\w+)\(([^)]*)\)", src):
        types_ = []
        for p in params.split(","):
            p = " ".join(p.split())
            types_.append(build._PTR if "*" in p else build._DBL
                          if p.startswith("double") else build._INT)
        out[entry] = types_
    return out


def test_the_c_signatures_are_the_bindings():
    sigs = {}
    for name in ("sqrt_filter", "sqrt_filter_block"):
        entries = _c_entries(name)
        mine = dict(build._SIGNATURES[name])
        assert {f"{b}_{s}" for b in mine for s in ("f32", "f64")} == set(
            entries), name
        for base, argtypes in mine.items():
            for suffix in ("f32", "f64"):
                assert entries[f"{base}_{suffix}"] == argtypes, base
        sigs.update(mine)
    assert set(sigs) == {
        "metran_sqrt_filter", "metran_sqrt_filter_gated",
        "metran_sqrt_filter_robust", "metran_sqrt_filter_block",
        "metran_sqrt_filter_gated_block", "metran_sqrt_filter_robust_block",
        "metran_sqrt_filter_model_bytes", "metran_sqrt_filter_occupancy"}
    # the group entries take W and G after the block entries' integers
    for base in ("metran_sqrt_filter", "metran_sqrt_filter_gated",
                 "metran_sqrt_filter_robust"):
        assert sigs[base] == sigs[base + "_block"][:-1] + [build._INT] * 2 \
            + [build._PTR]


def test_the_block_kernel_is_the_earlier_kernel():
    """The oracle's source launches sqrtk::run_steps (``sqrt_step.cuh``,
    which K16's square-root body shares) one 64-thread block a lane; the
    group kernel's source launches only the group step."""
    block = _source("sqrt_filter_block.cu")
    assert "sqrtk::run_steps<T, kStore, kBounds, kGate>(" in block
    assert "<<<L, kThreads, smem, (cudaStream_t)stream>>>" in block
    assert "constexpr int kThreads = 64;" in _source("sqrt_step.cuh")
    group = _source("sqrt_filter.cu")
    assert "sqrtk::run_steps" not in group
    assert "sqrtw::run_group<T, kStore, kBounds, kGate, kG>(" in group


def test_the_oracle_counts_its_launches_apart(monkeypatch):
    """The block kernel's launches go to their own counters, which the
    path counters' reset leaves alone; the group kernel keeps K9's
    names."""
    names = ("sqrt_filter", "sqrt_filter_gated", "sqrt_filter_robust")
    assert set(names) <= set(build.LAUNCHES)
    assert {n + "_block" for n in names} <= set(build.ORACLE_LAUNCHES)
    assert not set(build.ORACLE_LAUNCHES) & set(build.LAUNCHES)
    monkeypatch.setattr(build, "ORACLE_LAUNCHES",
                        dict.fromkeys(build.ORACLE_LAUNCHES, 0))
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    for name in names:
        build.count_launch(name + "_block")
        build.count_launch(name)
        assert build.oracle_launches()[name + "_block"] == 1
        assert build.launches()[name] == 1
    build.reset_launches()
    assert all(build.oracle_launches()[n + "_block"] == 1 for n in names)
    assert set(build.launches().values()) == {0}


def test_the_predict_skip_is_taken_only_for_a_triangular_finite_carry():
    """The group step's skip rule as the source states it: a top-block
    entry of the predict pre-array that is not finite, or nonzero above
    the carry's diagonal, sends the step to the block kernel's rows; a
    multiplier that is not finite sends the rest of the QR there."""
    src = _source("sqrt_warp_step.cuh")
    assert ("if (row < n && (!isfinite(v) || (row > c && v != T(0)))) "
            "off = 1;") in src
    assert "fl[kNotTri] ? 0 : n" in src
    assert "if (!full && !isfinite(u)) {" in src
    assert "const bool full = skip == 0 || *poll != 0;" in src
    # Z's zeros are skipped only while S_p and m_p are finite
    assert "const bool all_s = fl[kNanSp] != 0, all_m = fl[kNanMp] != 0;" \
        in src
