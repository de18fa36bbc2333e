"""K4's ring kernel (``csrc/lanes_adjoint.cu``): its launch geometry, its
shared-memory layout, its step records and its ring, mirrored in
``kernels/lanes.py``, held to the source; the C signatures of the ring
kernel and of its oracle (the warp kernel, ``csrc/lanes_adjoint_warp.cu``);
the wrappers' refusals of CPU tensors.  Pure Python: the kernels run on
the card (``tests/test_torch_kernels_cuda.py``), where the ring kernel is
held to the warp kernel bit for bit."""

import contextlib
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


def _record_text():
    src = _source("lanes_adjoint.cu")
    body = src[src.index("struct Record {"):]
    return body[:body.index("};")]


def _source_record(big_n, n):
    """``Record``'s fields evaluated from the source, in order."""
    env = {"N": big_n, "n": n}
    fields = {}
    for name, expr in re.findall(r"\n\s+(\w+) = ([^;]+);", _record_text()):
        fields[name] = eval(expr.replace("/", "//"), {}, {**env, **fields})
    return fields


def _source_layout(big_n, n, ring, stages, item):
    """``carve`` evaluated from the source: the bytes of each
    ``c.take<T>`` (``item`` each) and ``c.take<uint32_t>`` (4 each), in
    order, rounded up to 16 as its return does."""
    src = _source("lanes_adjoint.cu")
    body = src[src.index("__host__ __device__ size_t carve("):]
    body = body[:body.index("return (c.used + 15) / 16 * 16;")]
    env = {"N": big_n, "n": n, "R": ring, "stages": stages,
           "nw": -(-n // 32), "stride": _source_record(big_n, n)["stride"],
           "per": n * n + 2 * n + big_n + -(-big_n // item)}
    used = 0
    for kind, expr in re.findall(r"c\.take<(T|uint32_t)>\(base, (.+)\);",
                                 body):
        expr = (expr.replace("(size_t)", "").replace("s->per", "per")
                .replace("Record(N, n).stride", "stride"))
        used += eval(expr, {}, dict(env)) * (item if kind == "T" else 4)
    return -(-used // 16) * 16


def test_replay_workspace_mirrors_the_source():
    src = _source("lanes_adjoint.cu")
    assert ("return n * n + 2 * n + N + (N + (int)sizeof(T) - 1) / "
            "(int)sizeof(T);") in src


@pytest.mark.parametrize("big_n,n", [(20, 21), (24, 32), (1, 2), (5, 7),
                                     (40, 41), (60, 61), (72, 80), (7, 40)])
def test_record_stride_mirrors_the_source(big_n, n):
    rec = _source_record(big_n, n)
    assert rec["stride"] == kl.record_stride(big_n, n)
    assert kl.record_stride(big_n, n) % 4 == 0  # 16 bytes in f32 and f64
    # the warp kernel's record (mean0, cov0, d, f, v), then each slot's
    # three quotients and the mask
    assert rec["d"] == n + n * n and rec["f"] == rec["d"] + big_n * n
    assert rec["v"] + big_n == kl.scratch_stride(big_n, n) == rec["vb"]
    assert rec["fb"] == rec["vb"] + big_n and rec["vf"] == rec["fb"] + big_n
    assert rec["mk"] == rec["vf"] + big_n
    assert rec["stride"] - (rec["mk"] + big_n) in range(4)


@pytest.mark.parametrize("big_n,n", [(20, 21), (24, 32), (1, 2), (5, 7),
                                     (40, 41), (72, 80), (48, 56), (8, 104)])
@pytest.mark.parametrize("ring", [1, 2, 4])
@pytest.mark.parametrize("stages", [0, 1, 2])
def test_shared_memory_layout_mirrors_the_source(big_n, n, ring, stages):
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        want = _source_layout(big_n, n, ring, stages, item)
        assert kl.adjoint_smem_bytes(big_n, n, dtype, ring, stages) == want
        assert want % 16 == 0


@pytest.mark.parametrize("dtype,staged4", [(torch.float32, 20_368),
                                           (torch.float64, 40_576)])
def test_the_flagship_and_serving_layouts(dtype, staged4):
    # (20, 21): four replay warps and two staged records, a few KB; a
    # record fewer with one
    item = torch.finfo(dtype).bits // 8
    assert kl.adjoint_smem_bytes(20, 21, dtype, 4, 2) == staged4
    assert kl.adjoint_smem_bytes(20, 21, dtype, 4, 1) == \
        staged4 - 1_004 * item
    for big_n, n in ((20, 21), (24, 32)):
        assert kl.adjoint_smem_bytes(big_n, n, dtype, kl.RING_MAX, 2) \
            + kl.ADJOINT_STATIC_SMEM <= kl.MAX_SMEM
    # the least shape is what the wrapper's check holds to the card
    assert kl.smem_bytes("adjoint", 20, 21, dtype) == \
        kl.adjoint_smem_bytes(20, 21, dtype, 1, 0) \
        + kl.ADJOINT_STATIC_SMEM


def test_constants_mirror_the_source():
    src = _source("lanes_adjoint.cu")
    assert int(re.search(r"constexpr int kMaxRing = (\d+);", src)[1]) \
        == kl.RING_MAX
    assert "constexpr int kMaxSlots = kMaxRing + 1;" in src
    assert kl.SLOTS_MAX == kl.RING_MAX + 1
    assert ("__shared__ __align__(8) uint64_t full[kMaxSlots], "
            "empty[kMaxSlots];") in src
    assert kl.ADJOINT_STATIC_SMEM == 2 * kl.SLOTS_MAX * 8
    # a block: R replay warps and the sweep warps, a block per lane
    assert int(re.search(r"constexpr int kMaxSweep = (\d+);", src)[1]) \
        == kl.SWEEP_WARPS
    assert "<<<L, 32 * (R + kS), smem, stream>>>" in src
    assert ("__launch_bounds__(32 * (kMaxRing + kS),\n"
            "                                  Budget<T, kS, kStages>::kBlocks)"
            in src)
    assert "mbar_init(&empty[k], 32 * kS);" in src
    # two sweep warps with two staged records only
    assert ("S > kMaxSweep || stages < 0 || stages > 2 || (S == 2 && "
            "stages != 2))") in src
    assert src.count("return (int)cudaErrorInvalidValue;") == 2
    assert all(1 <= r <= kl.RING_MAX and sw in (1, 2) and st in (0, 1, 2)
               for r, sw, st in kl.WIDE)
    # two stages a step ahead by the step's parity, one after the step
    assert "return s.stage + (t & (kStages - 1)) * rc.stride;" in src
    assert "if (kStages == 2 && k > 0) copy(record(i, k - 1), t - 1);" in src
    assert "if (kStages == 1 && k > 0) copy(record(i, k - 1), t - 1);" in src
    # R or R + 1 slots: a slot's fills one mbarrier phase apart
    assert ("if (seg < 1 || R < 1 || R > kMaxRing || D < R || D > R + 1 || "
            "S < 1 ||") in src
    # the ring: D slots of seg records a lane
    assert "T* ring_l = ring + (size_t)l * D * seg * rc.stride;" in src
    assert "const int g = n_seg - 1 - i, slot = i % D, fill = i / D;" in src
    assert "for (int i = w; i < n_seg; i += R) {" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_ring_kernel_takes_every_bucket_the_warp_kernel_takes(dtype):
    """Every (N, n) with N < n <= 160 that the warp kernel's two-lane
    block fits, one ring block fits too (its least shape: one replay
    warp, records read in the ring), and the records are staged in
    shared memory at the flagship and serving buckets."""
    took = 0
    for big_n in range(1, 160):
        for n in range(big_n + 1, 161):
            if kl.smem_bytes("adjoint_warp", big_n, n, dtype) \
                    <= kl.MAX_SMEM:
                took += 1
                assert kl.smem_bytes("adjoint", big_n, n, dtype) \
                    <= kl.MAX_SMEM, (big_n, n)
    assert took > 1000


def _card(monkeypatch, sms=132, blocks=4, free=80 << 30, cached=0):
    """A card of ``sms`` SMs keeping ``blocks`` ring blocks resident
    each, ``free`` bytes free and ``cached`` more held free by PyTorch's
    allocator; records the occupancy queries."""
    asked = []

    def occupancy(big_n, n, dtype, ring, stages, sweep):
        asked.append((big_n, n, dtype, ring, stages, sweep))
        return blocks

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev: cached + (1 << 20))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev: 1 << 20)
    monkeypatch.setattr(kl, "adjoint_occupancy", occupancy)
    return asked


@pytest.mark.parametrize("lanes", [1, 64, 512, 528])
def test_ring_geometry_spends_warps_while_blocks_are_resident(monkeypatch,
                                                              lanes):
    """Four replay warps over four slots, two sweep warps and two staged
    records while every such block is resident (SMs times the occupancy
    calculator's blocks)."""
    asked = _card(monkeypatch)
    got = kl.ring_geometry(lanes, 5_000, 100, 20, 21, torch.float32, "cuda")
    assert got == (kl.RING_MAX, kl.RING_MAX, kl.SWEEP_WARPS, 2)
    assert asked == [(20, 21, torch.float32, kl.RING_MAX, 2,
                      kl.SWEEP_WARPS)]


# blocks an SM by (replay warps, sweep warps, stages), as registers and
# shared memory might allow: in f32 registers hold the blocks whatever
# the stages; in f64 shared memory, so one stage keeps more
WIDE_BLOCKS = {(4, 2, 2): 4, (2, 1, 2): 9, (1, 1, 2): 14, (2, 1, 1): 9,
               (1, 1, 1): 14, (1, 1, 0): 14}
WIDE_BLOCKS_F64 = {(4, 2, 2): 2, (2, 1, 2): 7, (1, 1, 2): 7, (2, 1, 1): 7,
                   (1, 1, 1): 10, (1, 1, 0): 16}


@pytest.mark.parametrize("lanes,shape", [
    (529, (2, 1)), (1_188, (2, 1)), (1_189, (1, 1)), (1_849, (2, 1)),
    (2_376, (2, 1)), (2_377, (1, 1)), (4_096, (1, 1)), (100_000, (1, 1))])
def test_ring_geometry_past_residency_takes_the_fewest_waves(monkeypatch,
                                                             lanes, shape):
    """Past the resident blocks: the WIDE shape with the fewest waves of
    resident blocks (1,188 and 1,848 lanes a wave here), then the most
    staged records (one stage keeps no more blocks here), then the most
    replay warps."""
    asked = []

    def occupancy(big_n, n, dtype, ring, stages, sweep):
        asked.append((ring, sweep, stages))
        return WIDE_BLOCKS[(ring, sweep, stages)]

    _card(monkeypatch)
    monkeypatch.setattr(kl, "adjoint_occupancy", occupancy)
    got = kl.ring_geometry(lanes, 5_000, 100, 20, 21, torch.float32, "cuda")
    room = max(1, kl.RING_BUDGET // kl.ring_bytes(lanes, 100, 20, 21,
                                                  torch.float32, 1))
    assert (got.sweep, got.stages) == (shape[1], 2)
    assert got.depth == min(shape[0] + 1, room)
    assert got.ring == min(shape[0], got.depth)
    assert asked == [(4, 2, 2)] + list(kl.WIDE)


@pytest.mark.parametrize("lanes,shape", [
    (529, (2, 1, 2)), (924, (2, 1, 2)), (925, (1, 1, 1)),
    (1_320, (1, 1, 1)), (1_321, (1, 1, 0)), (2_112, (1, 1, 0)),
    (2_113, (1, 1, 1)), (2_640, (1, 1, 1)), (2_641, (1, 1, 0)),
    (4_096, (1, 1, 0))])
def test_ring_geometry_past_residency_stages_fewer_records_for_fewer_waves(
        monkeypatch, lanes, shape):
    """Where shared memory holds the blocks (f64), fewer staged records
    keep more of them an SM (924 lanes a wave with two, 1,320 with one,
    2,112 with none): taken only where they save a wave."""
    def occupancy(big_n, n, dtype, ring, stages, sweep):
        return WIDE_BLOCKS_F64[(ring, sweep, stages)]

    _card(monkeypatch)
    monkeypatch.setattr(kl, "adjoint_occupancy", occupancy)
    got = kl.ring_geometry(lanes, 1_000, 100, 20, 21, torch.float64, "cuda")
    assert (got.ring, got.sweep, got.stages) == shape
    assert got.depth == got.ring + 1


def test_ring_geometry_past_residency_keeps_the_bucket_layout(monkeypatch):
    """A bucket whose records do not stage reads them in the ring past
    residency too, and one that stages one record stages no more."""
    for big_n, stages in ((74, 0), (62, 1)):
        asked = []

        def occupancy(big_n, n, dtype, ring, st, sweep):
            asked.append((ring, sweep, st))
            return 1

        _card(monkeypatch)
        monkeypatch.setattr(kl, "adjoint_occupancy", occupancy)
        got = kl.ring_geometry(10_000, 500, 100, big_n, big_n + 1,
                               torch.float64, "cuda")
        assert got.stages == stages and got.sweep == 1
        assert all(st <= stages for _, _, st in asked)


def test_ring_geometry_follows_the_segments_and_the_budget(monkeypatch):
    _card(monkeypatch)
    # fewer segments than replay warps: a warp and a slot each
    assert kl.ring_geometry(8, 250, 100, 20, 21, torch.float32,
                            "cuda") == (3, 3, 2, 2)
    assert kl.ring_geometry(8, 100, 100, 20, 21, torch.float32,
                            "cuda") == (1, 1, 2, 2)
    assert kl.ring_geometry(8, 0, 100, 20, 21, torch.float32,
                            "cuda") == (1, 1, 2, 2)
    # one segment of 5,000 steps a lane: one slot whatever the budget
    assert kl.ring_geometry(512, 5_000, 5_000, 20, 21, torch.float32,
                            "cuda") == (1, 1, 2, 2)
    # the budget cuts the depth, and the replay warps with it
    slot = kl.ring_bytes(512, 1_000, 20, 21, torch.float64, 1)
    assert slot == 512 * 1_000 * 1_004 * 8
    want = max(1, kl.RING_BUDGET // slot)
    r, d, _, _ = kl.ring_geometry(512, 20_000, 1_000, 20, 21,
                                  torch.float64, "cuda")
    assert d == r == min(kl.RING_MAX, want) == 2
    assert kl.ring_bytes(512, 1_000, 20, 21, torch.float64, d) \
        <= kl.RING_BUDGET


@pytest.mark.parametrize("free,cached,depth", [
    (80 << 30, 0, 4), (1 << 30, 0, 2), (1 << 30, 1 << 30, 4),
    (300 << 20, 0, 1), (0, 0, 1)])
def test_ring_geometry_takes_at_most_half_the_free_memory(monkeypatch, free,
                                                          cached, depth):
    """The ring takes at most RING_FREE_SHARE of what the card has free,
    counting what PyTorch's allocator holds free, and at least one slot:
    at B = 512, f32, seg = 100 a slot is 205.6 MB."""
    _card(monkeypatch, free=free, cached=cached)
    slot = kl.ring_bytes(512, 100, 20, 21, torch.float32, 1)
    assert slot == 205_619_200
    r, d, _, _ = kl.ring_geometry(512, 5_000, 100, 20, 21, torch.float32,
                                  "cuda")
    assert r == d == depth
    if depth > 1:
        assert d * slot <= kl.RING_FREE_SHARE * (free + cached)


@pytest.mark.parametrize("dtype,two,one", [(torch.float32, 88, 104),
                                          (torch.float64, 61, 73)])
def test_ring_geometry_stages_what_fits(monkeypatch, dtype, two, one):
    """Two staged records up to the widest one-factor bucket they fit
    beside a replay warp, then one, then none (read in the ring), each
    in the layout chosen."""
    item = torch.finfo(dtype).bits // 8
    room = kl.MAX_SMEM - kl.ADJOINT_STATIC_SMEM
    for big_n, stages in ((two, 2), (two + 1, 1), (one, 1), (one + 1, 0)):
        asked = _card(monkeypatch)
        assert (kl.adjoint_smem_bytes(big_n, big_n + 1, dtype, 1, stages)
                <= room)
        if stages < 2:
            assert kl.adjoint_smem_bytes(big_n, big_n + 1, dtype, 1,
                                         stages + 1) > room
        r, d, _, got = kl.ring_geometry(1, 500, 100, big_n, big_n + 1,
                                        dtype, "cuda")
        assert got == stages and 1 <= r <= kl.RING_MAX
        assert d == (r if r == kl.RING_MAX else r + 1)
        assert kl._ring_layout(big_n, big_n + 1, r, got, item) <= room
        assert asked[-1] == (big_n, big_n + 1, dtype, r, stages,
                             kl.SWEEP_WARPS if stages == 2 else 1)


def test_ring_geometry_keeps_a_spare_slot_below_the_most_replay_warps(
        monkeypatch):
    """D = R + 1 below RING_MAX replay warps and R at it, as the segments
    and the budget allow: a slot's fills one mbarrier phase apart."""
    _card(monkeypatch)
    for lanes in (1, 600):
        for t_steps, seg in ((1, 1), (5, 1), (250, 100), (5_000, 100),
                             (5_000, 7), (20_000, 5_000), (0, 3)):
            for dtype in (torch.float32, torch.float64):
                r, d, sw, _ = kl.ring_geometry(lanes, t_steps, seg, 20,
                                               21, dtype, "cuda")
                assert 1 <= r <= kl.RING_MAX and d in (r, r + 1)
                if r == kl.RING_MAX:
                    assert d == r
                elif d == r:  # cut by the segments or the budget
                    assert d == max(1, -(-t_steps // seg)) or \
                        kl.ring_bytes(lanes, seg, 20, 21, dtype, d + 1) \
                        > kl.RING_BUDGET
                assert sw in (1, kl.SWEEP_WARPS)
                assert d <= max(1, -(-t_steps // seg))


def test_the_ring_at_the_flagship_shape():
    # a slot: seg records of (20, 21); the fit's 512 lanes at seg = 100
    assert kl.record_stride(20, 21) == 1_004
    assert kl.ring_bytes(1, 100, 20, 21, torch.float32, 1) == 401_600
    assert kl.ring_bytes(512, 100, 20, 21, torch.float32, 4) == \
        512 * 4 * 401_600 == 822_476_800
    assert kl.ring_bytes(512, 100, 20, 21, torch.float64, 4) == \
        2 * 512 * 4 * 401_600


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
    for name in ("lanes_adjoint", "lanes_adjoint_warp"):
        entries = _c_entries(name)
        mine = build._SIGNATURES[name]
        mine = dict(mine if not isinstance(mine[0], str) else (mine,))
        assert {f"{b}_{s}" for b in mine for s in ("f32", "f64")} == set(
            entries), name
        for base, argtypes in mine.items():
            for suffix in ("f32", "f64"):
                assert entries[f"{base}_{suffix}"] == argtypes, base
        sigs.update(mine)
    assert set(sigs) == {"metran_lanes_adjoint",
                         "metran_lanes_adjoint_occupancy",
                         "metran_lanes_adjoint_warp"}
    # the ring entry takes R, D, S and stages after the warp entry's
    # integers
    assert sigs["metran_lanes_adjoint"] == \
        sigs["metran_lanes_adjoint_warp"][:-1] + [build._INT] * 4 \
        + [build._PTR]


def _k4_args(dtype=torch.float64, lanes=3, t=7, big_n=4, kf=1, seg=3):
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
    lane_map = torch.arange(lanes, dtype=torch.int32)
    fwd = kernels.lanes_filter(phi, q, z, r, y, mask, lane_map, seg,
                               keep_bounds=True)
    g = torch.Generator().manual_seed(1)
    sb = torch.randn(fwd.sigma.shape, generator=g, dtype=dtype)
    db = torch.randn(fwd.sigma.shape, generator=g, dtype=dtype)
    return (phi, q, z, r, y, mask, lane_map, seg, fwd.bounds_mean,
            fwd.bounds_cov, sb, db)


@pytest.mark.parametrize("launcher", ["lanes_adjoint_kernel",
                                      "lanes_adjoint_warp_kernel"])
def test_kernel_and_oracle_wrappers_refuse_cpu_tensors(launcher):
    args = _k4_args()
    before = build.launches(), build.oracle_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(kernels, launcher)(*args)
    assert (build.launches(), build.oracle_launches()) == before


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    args = _k4_args()
    before = build.launches(), build.oracle_launches()
    got = kernels.lanes_adjoint(*args)
    want = kernels.lanes_adjoint_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (build.launches(), build.oracle_launches()) == before


def test_the_oracle_counts_its_launches_apart(monkeypatch):
    assert "lanes_adjoint" in build.LAUNCHES
    assert "lanes_adjoint_warp" in build.ORACLE_LAUNCHES
    assert "lanes_adjoint_warp" not in build.LAUNCHES
    monkeypatch.setattr(build, "ORACLE_LAUNCHES",
                        dict.fromkeys(build.ORACLE_LAUNCHES, 0))
    monkeypatch.setattr(build, "LAUNCHES", dict.fromkeys(build.LAUNCHES, 0))
    build.count_launch("lanes_adjoint_warp")
    build.count_launch("lanes_adjoint")
    assert build.oracle_launches()["lanes_adjoint_warp"] == 1
    assert build.launches()["lanes_adjoint"] == 1
    build.reset_launches()
    assert build.oracle_launches()["lanes_adjoint_warp"] == 1
    assert set(build.launches().values()) == {0}


def _flat(src):
    """A source's statements with the ring kernel's layout prefix and
    names brought to the warp kernel's, whitespace collapsed."""
    src = (src.replace("s.u", "u").replace("s.pb", "pb").replace("s.qb", "qb")
           .replace("s.sd", "kv").replace("s.st", "st").replace("s.S", "S"))
    return " ".join(src.split())


# (the warp kernel's statement, the ring kernel's statements): each sum's
# terms in the same order, each entry by the same operations.  The ring
# kernel's row walks (walk_dot, walk_dot3, walk_scale) load a batch of
# entries before they are used, on S's rows (stride 1) or its columns
# (stride n); its replay warps compute the quotients that need no adjoint
# into the record (rec[rc.vb], rec[rc.fb], rec[rc.vf]); the column warp
# the two of u.d (s.ud); Sa = S + a * n; the observed slots come from the
# last by ballot.
SWEEP_PAIRS = [
    ("sd += S[a * n + b] * dv[b];",
     ("const T sd = walk_dot(S + a * n, 1, dv, n);",
      "acc += xs[e] * ds[e];", "xs[e] = x[(b + e) * sx];",
      "ds[e] = d[b + e];", "xs[e] = in ? x[(b + e) * sx] : T(0);",
      "if (b + e < n) acc += xs[e] * ds[e];")),
    ("sdt += S[b * n + a] * dv[b];",
     ("st[a] = walk_dot(S + a, n, dv, n);",)),
    ("ud_p += u[a] * dv[a];", ("ud_p += u[a] * dv[a];",)),
    ("dsd_p += dv[a] * sd;", ("dsd_p += dv[a] * sd;",)),
    ("const T ud = warp_sum(ud_p);", ("const T ud = warp_sum(ud_p);",)),
    ("const T dsd = warp_sum(dsd_p);", ("const T dsd = warp_sum(dsd_p);",)),
    ("const T vbar = T(2) * sbt * v / f + ud / f;",
     ("res[rc.vb + a] = T(2) * sbt * v / f;", "s.ud[0] = ud / f;",
      "const T vbar = rec[rc.vb + i] + s.ud[0];")),
    ("const T fbar = -sbt * v * v / (f * f) + dbt / f + dsd / (f * f) - "
     "ud * v / (f * f);",
     ("res[rc.fb + a] = -sbt * v * v / (f * f) + dbt / f;",
      "return dsd / (f * f);", "s.ud[1] = ud * v / (f * f);",
      "const T fbar = rec[rc.fb + i] + dsdf - s.ud[1];")),
    ("const T dvec = -(kv[a] + st[a]) / f + u[a] * (v / f) + fbar * zi[a];",
     ("res[rc.vf + a] = v / f;", "const T vf = rec[rc.vf + i];",
      "const T dvec = -(kv[a] + st[a]) / f + u[a] * vf + fbar * zi[a];")),
    ("S[a * n + b] = S[a * n + b] + dvec * zi[b];",
     ("Sa[b0] = s0 + dvec * z0;", "Sa[b1] = s1 + dvec * z1;",
      "const T s0 = Sa[b0], s1 = Sa[b1], z0 = zi[b0], z1 = zi[b1];",
      "Sa[b0] = Sa[b0] + dvec * zi[b0];",
      "for (int b = 0; b < n; ++b) Sa[b] = Sa[b] + dvec * zi[b];")),
    ("u[a] = u[a] - vbar * zi[a];", ("u[a] = u[a] - vbar * zi[a];",)),
    ("s1 += S[a * n + b] * P[a * n + b] * ph[b];",
     ("kv[a] = walk_dot3(S + a * n, P0 + a * n, 1, ph, n); // s1",
      "acc += xs[e] * ps[e] * hs[e];", "ps[e] = p[(b + e) * sx];",
      "hs[e] = h[b + e];")),
    ("s2 += S[b * n + a] * P[b * n + a] * ph[b];",
     ("st[a] = walk_dot3(S + a, P0 + a, n, ph, n); // s2",)),
    ("pb[a] = pb[a] + (u[a] * m[a] + s1 + s2);",
     ("const T s1 = kv[a], s2 = st[a];",
      "pb[a] = pb[a] + (u[a] * m0[a] + s1 + s2);")),
    ("qb[a] = qb[a] + S[a * n + a];", ("qb[a] = qb[a] + S[a * n + a];",)),
    ("u[a] = u[a] * pa;", ("u[a] = u[a] * ph[a];",)),
    ("S[a * n + b] = S[a * n + b] * pa * ph[b];",
     ("walk_scale(S + a * n, ph[a], ph, b_lo, b_hi);",
      "x[b + e] = xs[e] * pa * hs[e];",
      "for (; b < hi; ++b) x[b] = x[b] * pa * h[b];")),
    ("for (int i = N - 1; i >= 0; --i) {",
     ("const int j = 31 - __clz(obs); obs &= ~(1u << j);",
      "const int i = c * 32 + j;", "for (int c = (N - 1) / 32; c >= 0; --c)")),
]


@pytest.mark.parametrize("pair", SWEEP_PAIRS,
                         ids=[p[0] for p in SWEEP_PAIRS])
def test_the_sweep_is_the_warp_kernels_arithmetic(pair):
    """Each statement of the warp kernel's sweep and its counterparts in
    the ring kernel, in the same form (the association of every sum,
    hence its bits)."""
    old, new = pair
    assert old in _flat(_source("lanes_adjoint_warp.cu"))
    ring = _flat(_source("lanes_adjoint.cu"))
    for stmt in new:
        assert _flat(stmt) in ring, stmt


def test_the_replay_is_k3s_step_and_zeros_are_skipped_only_when_exact():
    ring = _source("lanes_adjoint.cu")
    assert ("lanes::filter_step(P, m, kv, s.Zs, s.ph, s.qd, s.rs, ys, ms, "
            "N, n,") in ring
    assert "lanes::filter_step(" in _source("lanes_filter.cu")
    assert "lanes::filter_step(" in _source("lanes_adjoint_warp.cu")
    # the rank-1 update on z_i's nonzeros only while dvec is finite
    assert "if (isfinite(dvec)) {" in ring
    assert "for (int b = 0; b < n; ++b) Sa[b] = Sa[b] + dvec * zi[b];" in ring
    assert "if (z[((size_t)i * n + w * 32 + j) * L + l] != T(0)) bits" in ring
    # the warp kernel is the earlier one: a warp a lane, two a block
    warp = _source("lanes_adjoint_warp.cu")
    assert "lanes_adjoint_kernel<T><<<blocks, kWarps * 32, smem," in warp
    assert "lanes::warp_elems<T>(2, 9, N, n)" in warp
    assert kl._WARP_SLICE["adjoint_warp"] == (2, 9)
