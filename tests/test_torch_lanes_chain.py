"""K3's chain kernel (``csrc/lanes_filter.cu`` over
``csrc/lanes_chain_step.cuh``): its launch geometry and its shared-memory
layout, mirrored in ``kernels/lanes.py``, held to the source; the order of
its short sums against the oracle's butterfly; its statements against the
oracle's step; the C signatures of the chain kernel and of its oracle (the
warp kernel, ``csrc/lanes_filter_warp.cu``); the wrappers' refusals of CPU
tensors.  Pure Python: the kernels run on the card
(``tests/test_torch_kernels_cuda.py``), where the chain kernel is held to
the warp kernel bit for bit."""

import contextlib
import itertools
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from metran_tpu_torch import kernels
from metran_tpu_torch.kernels import build
from metran_tpu_torch.kernels import lanes as kl

torch.set_num_threads(1)

CSRC = Path(kl.__file__).parent / "csrc"


def _source(name):
    return (CSRC / name).read_text()


def _source_layout(big_n, n, item):
    """``carve`` evaluated from the header: the bytes of each
    ``c.take<U>`` in order, rounded up to 16 as its return does."""
    src = _source("lanes_chain_step.cuh")
    body = src[src.index("__host__ __device__ size_t carve("):]
    body = body[:body.index("return (c.used + 15) / 16 * 16;")]
    sizes = {"T": item, "int4": 16, "uint32_t": 4, "int": 4, "uint8_t": 1}
    env = {"N": big_n, "n": n, "ld": n | 1, "nw": -(-n // 32),
           "kSlots": kl.CHAIN_SLOTS}
    used = 0
    for kind, expr in re.findall(r"c\.take<(\w+)>\(base, (.+)\);", body):
        used += eval(expr.replace("(size_t)", ""), {}, dict(env)) \
            * sizes[kind]
    return -(-used // 16) * 16


@pytest.mark.parametrize("big_n,n", [(20, 21), (24, 32), (1, 2), (5, 6),
                                     (5, 7), (40, 41), (60, 61), (72, 80),
                                     (7, 40), (118, 119), (128, 131)])
@pytest.mark.parametrize("dtype,item", [(torch.float32, 4),
                                        (torch.float64, 8)])
def test_shared_memory_layout_mirrors_the_source(big_n, n, dtype, item):
    want = _source_layout(big_n, n, item)
    assert kl.chain_smem_bytes(big_n, n, dtype) == want
    assert want % 16 == 0
    assert kl.smem_bytes("filter", big_n, n, dtype) == \
        want + kl.CHAIN_STATIC_SMEM


@pytest.mark.parametrize("dtype,flagship,serving", [
    (torch.float32, 4_896, 9_232), (torch.float64, 9_520, 18_160)])
def test_the_flagship_and_serving_layouts(dtype, flagship, serving):
    # a lane's P on odd rows (21 values at n = 21, 33 at n = 32), Z, the
    # ring of four records and the step's vectors: a few KB, one lane a
    # block, less than the oracle's block of two warp lanes
    assert kl.chain_smem_bytes(20, 21, dtype) == flagship
    assert kl.chain_smem_bytes(24, 32, dtype) == serving
    assert kl.smem_bytes("filter_warp", 20, 21, dtype) > flagship


def test_constants_mirror_the_source():
    step = _source("lanes_chain_step.cuh")
    src = _source("lanes_filter.cu")
    assert int(re.search(r"constexpr int kMaxU = (\d+);", step)[1]) == \
        max(kl.UPDATE_WARPS)
    assert sorted(kl.UPDATE_WARPS) == [0, max(kl.UPDATE_WARPS)]
    assert int(re.search(r"constexpr int kSlots = (\d+);", step)[1]) == \
        kl.CHAIN_SLOTS
    assert int(re.search(r"constexpr int kMaxN = (\d+);", step)[1]) == \
        kl.CHAIN_MAX_SERIES
    assert ("__shared__ __align__(8) uint64_t full[chain::kSlots], "
            "empty[chain::kSlots];") in src
    assert kl.CHAIN_STATIC_SMEM == 2 * kl.CHAIN_SLOTS * 8
    # a block a lane: the chain warp and U update warps
    assert "lanes_filter_kernel<T, U><<<L, 32 * (U + 1), smem, stream>>>(" \
        in src
    assert "__launch_bounds__(32 * (U + 1), Budget<U>::kBlocks)" in src
    assert "static constexpr int kBlocks = U == 0 ? 32 : 4;" in src
    # full: the chain warp arrives; empty: each update warp
    assert "chain::mbar_init(&full[k], 1);" in src
    assert "chain::mbar_init(&empty[k], U > 0 ? U : 1);" in src
    # P on odd rows
    assert "const int ld = n | 1;" in step
    # the refusals of the C entry: U = 0 or kMaxU
    assert ("return (U == 0 || U == chain::kMaxU) && N >= 0 && N <= "
            "chain::kMaxN &&") in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_chain_kernel_takes_every_bucket_the_warp_kernel_takes(dtype):
    """Every (N, n) with N < n <= 160 that the warp kernel's two-lane
    block fits, one chain block fits too, within the series it takes."""
    took = 0
    for big_n in range(1, 160):
        for n in range(big_n + 1, 161):
            if kl.smem_bytes("filter_warp", big_n, n, dtype) <= kl.MAX_SMEM:
                took += 1
                assert big_n <= kl.CHAIN_MAX_SERIES, (big_n, n)
                assert kl.smem_bytes("filter", big_n, n, dtype) \
                    <= kl.MAX_SMEM, (big_n, n)
    assert took > 1000


def _card(monkeypatch, occupancy, sms=132):
    """A card of ``sms`` SMs keeping ``occupancy[U]`` chain blocks
    resident each; records the occupancy queries."""
    asked = []

    def query(big_n, n, dtype, u):
        asked.append(u)
        return occupancy[u]

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kl, "chain_occupancy", query)
    return asked


# blocks an SM by update warps, as the register budgets allow
BLOCKS = {3: 4, 0: 32}


@pytest.mark.parametrize("lanes,update_warps", [
    (1, 3), (64, 3), (512, 3), (528, 3), (529, 0), (1_024, 0), (2_048, 0),
    (4_224, 0), (21_504, 0)])
def test_chain_shape_spends_warps_while_blocks_are_resident(monkeypatch,
                                                            lanes,
                                                            update_warps):
    """Three update warps while every four-warp block is resident (the
    fleet of 512); past that the chain warp alone (the line search's 2,048
    trial lanes, the lanes-fd stderr's 21,504), whatever the waves."""
    asked = _card(monkeypatch, BLOCKS)
    got = kl.chain_shape(lanes, 20, 21, torch.float32, "cuda")
    assert got == kl.ChainShape(update_warps)
    assert asked == [max(kl.UPDATE_WARPS)]


def test_chain_shape_follows_the_resident_blocks(monkeypatch):
    # an f64 card keeping two four-warp blocks an SM: 264 lanes
    _card(monkeypatch, {3: 2, 0: 21})
    assert kl.chain_shape(264, 20, 21, torch.float64, "cuda") == \
        kl.ChainShape(3)
    assert kl.chain_shape(265, 20, 21, torch.float64, "cuda") == \
        kl.ChainShape(0)


def test_chain_shape_without_lanes_takes_the_most_update_warps(monkeypatch):
    _card(monkeypatch, BLOCKS)
    assert kl.chain_shape(0, 20, 21, torch.float32, "cuda") == \
        kl.ChainShape(max(kl.UPDATE_WARPS))


def _c_entries(name):
    """``{name: [ctypes type, ...]}`` of the extern "C" functions in
    ``csrc/<name>.cu``, from their parameter lists."""
    src = _source(f"{name}.cu")
    src = src[src.index('extern "C" {'):]
    out = {}
    for entry, params in re.findall(r"\nint (metran_\w+)\(([^)]*)\)", src):
        out[entry] = [build._PTR if "*" in p else build._INT
                      for p in params.split(",")]
    return out


def test_the_c_signatures_are_the_bindings():
    sigs = {}
    for name in ("lanes_filter", "lanes_filter_warp"):
        entries = _c_entries(name)
        mine = build._SIGNATURES[name]
        mine = dict(mine if not isinstance(mine[0], str) else (mine,))
        assert {f"{b}_{s}" for b in mine for s in ("f32", "f64")} == set(
            entries), name
        for base, argtypes in mine.items():
            for suffix in ("f32", "f64"):
                assert entries[f"{base}_{suffix}"] == argtypes, base
        sigs.update(mine)
    assert set(sigs) == {"metran_lanes_filter",
                         "metran_lanes_filter_occupancy",
                         "metran_lanes_filter_warp"}
    # the chain entry takes U after the warp entry's integers
    assert sigs["metran_lanes_filter"] == \
        sigs["metran_lanes_filter_warp"][:-1] + [build._INT, build._PTR]


def _k3_args(dtype=torch.float64, lanes=3, t=7, big_n=4, kf=1):
    from metran_tpu_torch.ops.lanes import lanes_statespace

    rng = np.random.default_rng(0)
    n = big_n + kf
    phi, q, z, r = lanes_statespace(
        torch.as_tensor(rng.uniform(2.0, 50.0, (n, lanes)), dtype=dtype),
        torch.as_tensor(rng.uniform(0.4, 0.8, (big_n, kf, lanes)),
                        dtype=dtype),
        torch.ones(lanes, dtype=dtype))
    y = torch.as_tensor(rng.normal(size=(lanes, t, big_n)), dtype=dtype)
    mask = torch.as_tensor(rng.uniform(size=(lanes, t, big_n)) > 0.3)
    return phi, q, z, r, y, mask, torch.arange(lanes, dtype=torch.int32)


@pytest.mark.parametrize("launcher", ["lanes_filter_kernel",
                                      "lanes_filter_warp_kernel"])
def test_kernel_and_oracle_wrappers_refuse_cpu_tensors(launcher):
    args = _k3_args()
    before = build.launches(), build.oracle_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(kernels, launcher)(*args, seg=3, keep_bounds=True)
    assert (build.launches(), build.oracle_launches()) == before


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    args = _k3_args()
    before = build.launches(), build.oracle_launches()
    got = kernels.lanes_filter(*args, seg=3, keep_bounds=True)
    want = kernels.lanes_filter_plain(*args, seg=3, keep_bounds=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (build.launches(), build.oracle_launches()) == before


def test_the_oracle_counts_its_launches_apart(monkeypatch):
    assert "lanes_filter" in build.LAUNCHES
    assert "lanes_filter_warp" in build.ORACLE_LAUNCHES
    assert "lanes_filter_warp" not in build.LAUNCHES
    monkeypatch.setattr(build, "ORACLE_LAUNCHES",
                        dict.fromkeys(build.ORACLE_LAUNCHES, 0))
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    build.count_launch("lanes_filter_warp")
    build.count_launch("lanes_filter")
    assert build.oracle_launches()["lanes_filter_warp"] == 1
    assert build.launches()["lanes_filter"] == 1
    build.reset_launches()
    assert build.oracle_launches()["lanes_filter_warp"] == 1
    assert set(build.launches().values()) == {0}


# ----------------------------------------------------------------------
# the short sums: the oracle's warp_sum, a butterfly over 32 lanes, holds
# a term of column a in lane a (n <= 32) and +0 elsewhere; the chain adds
# only the nonzero terms, in the order plan_of gives
# ----------------------------------------------------------------------
def _butterfly(values):
    """lanes::warp_sum, lane by lane, in the values' dtype."""
    x = np.array(values)
    for o in (16, 8, 4, 2, 1):
        x = x + x[np.arange(32) ^ o]
    assert len(set(x.tolist())) == 1
    return x[0]


def _bitrev5(x):
    return int(f"{x:05b}"[::-1], 2)


def _plan(cols):
    """plan_of's count and first pair, from the header's rule: the terms
    in bit-reversed order of their lanes; the adjacent pair whose lanes
    differ in the lower highest bit meets first."""
    cols = sorted(cols)
    pair = 0
    if len(cols) == 3:
        o = sorted(range(3), key=lambda k: _bitrev5(cols[k]))
        g1 = (_bitrev5(cols[o[0]]) ^ _bitrev5(cols[o[1]])).bit_length()
        g2 = (_bitrev5(cols[o[1]]) ^ _bitrev5(cols[o[2]])).bit_length()
        first = sorted((o[0], o[1]) if g1 < g2 else (o[1], o[2]))
        pair = {(0, 1): 0, (0, 2): 1, (1, 2): 2}[tuple(first)]
    return len(cols), pair


def _sum3(x, pair):
    """chain::sum3 of three terms (each add rounded), fewer padded with
    zeros."""
    x = np.concatenate([x, np.zeros(3 - len(x), x.dtype)])
    a = x[1] if pair == 2 else x[0]
    b = x[1] if pair == 0 else x[2]
    c = x[2] if pair == 0 else (x[1] if pair == 1 else x[0])
    return (a + b) + c


def test_the_plan_rule_is_in_the_header():
    step = _source("lanes_chain_step.cuh")
    assert "__device__ __forceinline__ int bitrev5(int x) { return " \
        "__brev(x) >> 27; }" in step
    assert ("const int g1 = 31 - __clz(bitrev5(col[o[0]]) ^ "
            "bitrev5(col[o[1]]));") in step
    assert "const int u = g1 < g2 ? o[0] : o[1], v = g1 < g2 ? o[1] : o[2];" \
        in step
    assert "pair = (lo == 0 && hi == 1) ? 0 : (lo == 0 ? 1 : 2);" in step
    assert "for (int k = cnt; k < kFast; ++k) col[k] = col[0];" in step
    for stmt in ("const T a = pair == 2 ? x1 : x0;",
                 "const T b = pair == 0 ? x1 : x2;",
                 "const T c = pair == 0 ? x2 : (pair == 1 ? x1 : x0);",
                 "return add_rn(add_rn(a, b), c);"):
        assert stmt in step


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_short_sums_are_the_butterfly_bit_for_bit(size, dtype):
    """Every set of one, two or three lanes of 32, random terms of mixed
    magnitude: the three-term sum (padded with zeros) equals the butterfly
    over 32 lanes whose other lanes hold +0."""
    rng = np.random.default_rng(size)
    for cols in itertools.combinations(range(32), size):
        cnt, pair = _plan(cols)
        for _ in range(3):
            terms = (rng.normal(size=size)
                     * 10.0 ** rng.integers(-6, 7, size)).astype(dtype)
            lanes = np.zeros(32, dtype)
            lanes[list(cols)] = terms
            assert _sum3(terms, pair) == _butterfly(lanes), cols


def test_the_flagship_plans():
    # one factor: the series' own column and the factor's, any order
    assert _plan((3, 20)) == (2, 0)
    # two factors (n = 22): lanes 3 and 21 differ in bits 1 and 3, 3 and
    # 20, 20 and 21 in bit 0, so the butterfly adds (x3 + x21) + x20;
    # lanes 4 and 20 meet at its first level: (x4 + x20) + x21
    assert _plan((3, 20, 21)) == (3, 1)
    assert _plan((4, 20, 21)) == (3, 0)


# ----------------------------------------------------------------------
# the chain's statements are the oracle's (lanes_step.cuh): every entry by
# the same operations, every sum's terms in the same order
# ----------------------------------------------------------------------
def _flat(src):
    return " ".join(src.split())


# (the oracle's statement, the chain kernel's statements), each rounding
# of the chain named by an intrinsic as nvcc compiles the oracle's: the row
# dot over z_i's nonzero columns (acc, dot3: the first product
# rounded alone, then an fma a term, as the oracle's fma chain over every
# column leaves it), the partials (x, p: a product rounded alone, the
# oracle's fma onto a butterfly lane's +0) and their sums (the
# butterfly's adds); the gain; the mean (an fma); the rank-1 update on the
# chain's columns (two at a time) and the update warps' (a batch of rows
# loaded first): the product k_a k_b, then an fma with -f into P; the
# predict on both (two products and an add, unfused: the diagonal's
# select keeps the oracle's apart); sigma/log f summed in slot order
STEP_PAIRS = [
    ("acc += P[a * n + b] * zi[b];",
     ("acc = fma_rn(Pa[b], zi[b], acc);",
      "return fma_rn(row[c2], z2, fma_rn(row[c1], z1, mul_rn(row[c0], "
      "z0)));",
      "const T acc = dot3(P + row * ld, c0, c1, c2, z0, z1, z2);",
      "const T d0 = dot3(P + c0 * ld, c0, c1, c2, z0, z1, z2);")),
    ("for (int a = lane; a < n; a += 32) part += zi[a] * m[a];",
     ("for (int a = lane; a < n; a += 32) part = fma_rn(zi[a], s.m[a], "
      "part);", "x0 = mul_rn(z0, s.m[c0])", "x1 = mul_rn(z1, s.m[c1])",
      "x2 = mul_rn(z2, s.m[c2])")),
    ("const T v = yi - warp_sum(part);",
     ("v = sub_rn(yi, warp_sum(part));",
      "v = sub_rn(yi, sum3(x0, x1, x2, pair));")),
    ("fpart += zi[a] * acc;",
     ("fpart = fma_rn(zi[a], acc, fpart);", "p0 = mul_rn(z0, d0)",
      "p1 = mul_rn(z1, d1)", "p2 = mul_rn(z2, d2)")),
    ("const T f = warp_sum(fpart) + ri;",
     ("f = add_rn(warp_sum(fpart), s.rs[i]);",
      "f = add_rn(sum3(p0, p1, p2, pair), s.rs[i]);")),
    ("for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);",
     ("return add_rn(add_rn(a, b), c);",)),
    ("kv[a] = kv[a] / f;", ("k[a] = k[a] / f;", "kown = acc / f;")),
    ("m[a] = m[a] + ka * v;",
     ("for (int a = lane; a < n; a += 32) s.m[a] = fma_rn(k[a], v, "
      "s.m[a]);", "if (lane < n) s.m[lane] = fma_rn(kown, v, s.m[lane]);")),
    ("P[a * n + b] = P[a * n + b] - ka * kv[b] * f;",
     ("Pa[b] = fma_rn(-f, mul_rn(ka, k[b]), Pa[b]);",
      "const T p0 = Pa[c0], p1 = Pa[c1], p2 = Pa[c2];",
      "if (cnt > 0) Pa[c0] = fma_rn(-f, mul_rn(kown, k0), p0);",
      "if (cnt > 2) Pa[c2] = fma_rn(-f, mul_rn(kown, k2), p2);",
      "const T k0 = __shfl_sync(kFull, kown, c0),",
      "Pb[(a + x * astep) * ld] = fma_rn(-f, mul_rn(ka[x], kb), p[x]);")),
    ("P[a * n + b] = pa * P[a * n + b] * ph[b] + (a == b ? qd[a] : T(0));",
     ("return add_rn(mul_rn(mul_rn(pa, x), s.ph[b]), a == b ? s.qd[a] : "
      "T(0));", "Pa[b] = predicted(s, pa, x, a, b);",
      "if (cnt > 1) Pa[c1] = predicted(s, pa, x1, a, c1);",
      "Pb[r * ld] = predicted(s, pa[x], p[x], r, b);")),
    ("m[a] = pa * m[a];",
     ("for (int a = lane; a < n; a += 32) s.m[a] = mul_rn(s.m[a], "
      "s.ph[a]);",)),
    ("sig = sig + v * v / f;", ("v[i] = div_rn(mul_rn(vi, vi), fi);",
                                "sig = add_rn(sig, v[i]);")),
    ("det = det + log(f);", ("f[i] = log(fi);", "det = add_rn(det, f[i]);")),
]


def test_the_roundings_are_named():
    """The short sums and row dots round by intrinsics (never fused by the
    compiler), in both types."""
    step = _source("lanes_chain_step.cuh")
    for f32, f64 in (("__fmul_rn(a, b)", "__dmul_rn(a, b)"),
                     ("__fadd_rn(a, b)", "__dadd_rn(a, b)"),
                     ("__fsub_rn(a, b)", "__dsub_rn(a, b)"),
                     ("__fdiv_rn(a, b)", "__ddiv_rn(a, b)"),
                     ("__fmaf_rn(a, b, c)", "__fma_rn(a, b, c)")):
        assert f"return {f32};" in step and f"return {f64};" in step


@pytest.mark.parametrize("pair", STEP_PAIRS, ids=[p[0] for p in STEP_PAIRS])
def test_the_chain_is_the_oracles_arithmetic(pair):
    """Each statement of the oracle's step and its counterparts in the
    chain kernel, in the same form (the association of every sum, hence
    its bits)."""
    old, new = pair
    assert _flat(old) in _flat(_source("lanes_step.cuh"))
    chain = _flat(_source("lanes_chain_step.cuh"))
    for stmt in new:
        assert _flat(stmt) in chain, stmt


def test_filter_step_stays_the_oracles_and_the_guards_step():
    """lanes::filter_step is the warp kernel's step, the step a lane whose
    guard fails finishes on, and K4's replay."""
    chain_src = _source("lanes_filter.cu")
    assert "lanes::filter_step(s.P, s.m, s.kv, s.Zs, s.ph, s.qd, s.rs, " \
        "s.ys, s.ms, N," in chain_src
    assert "lanes::series_update(s.P, s.m, s.kv, s.Zs + i * n, s.ys[i], " \
        "s.rs[i], n," in chain_src
    warp = _source("lanes_filter_warp.cu")
    assert "lanes::filter_step(P, m, kv, Zs, ph, qd, rs, ys, ms, N, n, " \
        "lane, sig," in warp
    assert "lanes_filter_kernel<T><<<blocks, kWarps * 32, smem," in warp
    assert "lanes::warp_elems<T>(1, 4, N, n)" in warp
    assert kl._WARP_SLICE["filter_warp"] == (1, 4)
    assert "lanes::filter_step(" in _source("lanes_adjoint.cu")
    # the guard: the skipped zeros only while the bound holds and every
    # gain is within the cap
    step = _source("lanes_chain_step.cuh")
    assert "if (!g.safe) {  // the oracle's step from here on, alone" in step
    assert "ok = fabs(kown) <= T(kGainCap);" in step
    assert "g.update(__all_sync(kFull, ok), f, v);" in step
