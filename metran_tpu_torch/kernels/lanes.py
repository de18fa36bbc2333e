"""K3/K4 wrappers: the lane-layout sequential filter and its adjoint.

:func:`lanes_filter` (K3) runs the masked sequential-processing Kalman
filter for ``L`` independent lanes from ``N(0, I)``: per step a diagonal
predict, then one masked rank-1 update per series slot in ascending
order.  It emits each step's ``sigma = sum v^2/f`` and ``detf = sum
log f``, the final filtered carry and, with ``keep_bounds``, the carry
at the start of every segment of ``seg`` steps.

:func:`lanes_adjoint` (K4) is its closed-form reverse sweep: given the
segment boundaries and the cotangents of ``(sigma, detf)``, it replays
each segment forward from its boundary, keeping the per-step
``(mean0, cov0, d, f, v)``, and runs the series adjoints in reverse slot
order, then the predict adjoint, accumulating ``phibar`` and ``qbar``.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/lanes_filter.cu``, ``csrc/lanes_adjoint.cu``) and raises if that
cannot build or launch; on CPU tensors it runs the plain PyTorch
version beside it (``*_plain``), the oracle the kernel is held against
on the card.  K3's kernel is a block per lane whose chain warp runs each
observed slot on z_i's nonzero columns while its update warps apply the
rest of each rank-1 update and the predicts a few events behind
(:func:`chain_shape` picks how many); the earlier kernel, one warp per
lane (``csrc/lanes_filter_warp.cu``, :func:`lanes_filter_warp_kernel`),
stays beside it as its bit-for-bit oracle, launched by no path.  K4's
kernel is a block per lane whose replay warps fill a ring of segment
records while its sweep warps run back over them (:func:`ring_geometry`
picks its shape); its earlier kernel, one warp per lane replaying and
sweeping in turn (``csrc/lanes_adjoint_warp.cu``,
:func:`lanes_adjoint_warp_kernel`), stays beside it as its oracle.

Layouts (lane axis LAST, as in the JAX package, except the data):

- ``phi``, ``q`` (n, L): diagonal transition and process noise;
- ``z`` (N, n, L), ``r`` (N, L): observation matrix and noise;
- ``y``, ``mask`` (D, T, N): the observations of ``D`` data lanes, a
  lane's step as N contiguous values (the kernels' layout);
- ``lane_map`` (L,) int32: the data lane each lane reads, so ``K`` trial
  points of a line search run as one launch over ``K*D`` lanes that read
  one copy of the data;
- ``sigma``, ``detf`` (T, L); boundaries (n_seg, n, L) and
  (n_seg, n, n, L); ``phibar``, ``qbar`` (n, L).

Time is cut into ``n_seg = ceil(T / seg)`` segments; the steps that pad
the last one are all-masked no-ops (a predict only) whose outputs are
trimmed, as ``_segment`` pads them in the JAX package.

Replaces ``metran_tpu/ops/lanes.py::_run_segments`` (B1: ``_adj_step``,
``_predict_step``, ``_adj_series_update``) and ``_terms_adjoint_bwd``
(B2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .joint_filter import MAX_SMEM

#: lanes (warps) per thread block of K5, K6, K7 and the warp kernels of K3
#: and K4 (their oracles)
WARPS_PER_BLOCK = 2
#: K3's chain kernel: a block a lane of a chain warp and U update warps, U
#: in UPDATE_WARPS (three while every such block is resident, else none);
#: the ring's event records; the series a lane it takes (a step's data is
#: held a step ahead, four a thread)
UPDATE_WARPS = (3, 0)
CHAIN_SLOTS = 4
CHAIN_MAX_SERIES = 128
#: static shared memory of a chain block: the full and empty mbarriers of
#: the ring's records, 8 bytes each, beside the dynamic layout
CHAIN_STATIC_SMEM = 2 * CHAIN_SLOTS * 8
#: K4's ring kernel: replay warps at most and the ring's slots at most; a
#: block is R replay warps and one or two sweep warps (two only with two
#: staged records)
RING_MAX = 4
SLOTS_MAX = RING_MAX + 1
SWEEP_WARPS = 2
#: the shapes (replay warps, sweep warps, staged records) a fleet past the
#: card's resident blocks may take: one sweep warp, few replay warps, one
#: staged record or none where that keeps more blocks an SM
WIDE = ((2, 1, 2), (1, 1, 2), (2, 1, 1), (1, 1, 1), (1, 1, 0))
#: static shared memory of a ring block: the full and empty mbarriers of
#: SLOTS_MAX slots, 8 bytes each, beside the dynamic layout
ADJOINT_STATIC_SMEM = 2 * SLOTS_MAX * 8
#: device memory the ring may take over every lane, and at most this share
#: of what the card has free: its depth is cut to both
RING_BUDGET = 8 << 30
RING_FREE_SHARE = 0.5


class LanesFilterResult(NamedTuple):
    """K3's outputs: per-step terms, the final filtered carry and, when
    asked for, the carry at the start of each segment."""

    sigma: torch.Tensor  # (T, L)
    detf: torch.Tensor  # (T, L)
    mean: torch.Tensor  # (n, L)
    cov: torch.Tensor  # (n, n, L)
    bounds_mean: Optional[torch.Tensor] = None  # (n_seg, n, L)
    bounds_cov: Optional[torch.Tensor] = None  # (n_seg, n, n, L)


# ----------------------------------------------------------------------
# shapes and shared memory
# ----------------------------------------------------------------------
#: per kernel of a warp a lane: (n x n matrices, n-vectors) in one lane's
#: warp slice, beside Z (N x n), two N-vectors and the step's mask bytes
#: (mirrors ``lanes::warp_elems`` calls in the sources); ``filter_warp``
#: and ``adjoint_warp`` are K3's and K4's oracles
_WARP_SLICE = {"filter_warp": (1, 4), "adjoint_warp": (2, 9),
               "smooth": (2, 7), "forward": (1, 4), "sample": (0, 3)}


def _warp_elems(kind: str, n_obs: int, n_state: int, itemsize: int) -> int:
    """Shared-memory values one lane's warp takes (``_WARP_SLICE``),
    rounded up so every warp's slice stays 16-byte aligned."""
    n, big_n = n_state, n_obs
    mats, vecs = _WARP_SLICE[kind]
    elems = (mats * n * n + big_n * n + vecs * n + 2 * big_n
             + -(-big_n // itemsize))
    return -(-elems // 4) * 4


def smem_bytes(kind: str, n_obs: int, n_state: int,
               dtype: torch.dtype) -> int:
    """Shared memory one block of a lanes kernel needs: K5
    (``kind="smooth"``), K6 (``"forward"``), K7 (``"sample"``) or the
    warp kernels of K3 and K4 (``"filter_warp"``, ``"adjoint_warp"``),
    dynamic; K3 (``"filter"``, every shape alike) and K4 (``"adjoint"``,
    its least shape: one replay warp, records read in the ring) with
    their static barriers."""
    item = torch.finfo(dtype).bits // 8
    if kind == "adjoint":
        return (_ring_layout(n_obs, n_state, 1, 0, item)
                + ADJOINT_STATIC_SMEM)
    if kind == "filter":
        return chain_smem_bytes(n_obs, n_state, dtype) + CHAIN_STATIC_SMEM
    return WARPS_PER_BLOCK * _warp_elems(kind, n_obs, n_state, item) * item


def chain_smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K3 block (mirrors ``carve`` in
    ``csrc/lanes_chain_step.cuh``, array by array): the ring's records
    (16 bytes each); P on rows of ``n | 1`` values; Z; m, phi, q; r, the
    step's y, the chain's v and f; the oracle's gain; the ring's gains,
    v and f; update warp 0's v and f; Z's nonzeros as 32-bit words; a
    plan a series; the step's mask and the marks, a byte a series."""
    n, big_n = n_state, n_obs
    item = torch.finfo(dtype).bits // 8
    values = (n * (n | 1) + big_n * n + 3 * n + 4 * big_n + n
              + CHAIN_SLOTS * n + 2 * CHAIN_SLOTS + 2 * big_n)
    used = (16 * CHAIN_SLOTS + values * item + 4 * big_n * (-(-n // 32))
            + 4 * big_n + 2 * big_n)
    return -(-used // 16) * 16


def scratch_stride(n_obs: int, n_state: int) -> int:
    """Values K4's warp kernel keeps per replayed step and lane:
    ``mean0`` (n), ``cov0`` (n*n), ``d`` (N*n), ``f`` (N) and ``v`` (N);
    its scratch is one segment of them.  The ring kernel's step record
    (:func:`record_stride`) adds the step's mask, ``sb`` and ``db``, and
    a slot of its ring holds a segment of records."""
    n = n_state
    return n + n * n + n_obs * n + 2 * n_obs


def record_stride(n_obs: int, n_state: int) -> int:
    """Values of one step's record in K4's ring (``Record`` in
    ``csrc/lanes_adjoint.cu``): :func:`scratch_stride`'s, each observed
    slot's ``2 sb v/f``, ``-sb v^2/f^2 + db/f`` and ``v/f`` (N each), and
    the mask (N), padded to a multiple of 4 (16 bytes)."""
    return -(-(scratch_stride(n_obs, n_state) + 4 * n_obs) // 4) * 4


def _ring_layout(n_obs: int, n_state: int, ring: int, stages: int,
                 item: int) -> int:
    """Dynamic shared-memory bytes of one K4 block with ``ring`` replay
    warps (mirrors ``carve`` in ``csrc/lanes_adjoint.cu``, array by
    array): ``stages`` staged records (0, 1 or 2); Z, r, phi, q; the
    sweep's S, five n-vectors and two scalars; each replay warp's P, m,
    gain, data and mask bytes; Z's nonzeros as 32-bit words."""
    n, big_n = n_state, n_obs
    stage = stages * record_stride(big_n, n)
    common = big_n * n + big_n + 2 * n
    sweep = n * n + 5 * n + 2
    per = n * n + 2 * n + big_n + -(-big_n // item)
    values = stage + common + sweep + ring * per
    words = big_n * (-(-n // 32))
    return -(-(values * item + 4 * words) // 16) * 16


def adjoint_smem_bytes(n_obs: int, n_state: int, dtype: torch.dtype,
                       ring: int, stages: int) -> int:
    """Dynamic shared memory of one K4 block with ``ring`` replay warps and
    ``stages`` records staged in shared memory (0: read in the ring)."""
    return _ring_layout(n_obs, n_state, ring, stages,
                        torch.finfo(dtype).bits // 8)


_OCCUPANCY: dict = {}


def adjoint_occupancy(n_obs: int, n_state: int, dtype: torch.dtype,
                      ring: int, stages: int,
                      sweep: int = SWEEP_WARPS) -> int:
    """Blocks of K4 the current card keeps resident per SM at this shape,
    ring, stages and sweep (CUDA's occupancy calculator; builds the
    kernels)."""
    import ctypes

    key = (torch.cuda.current_device(), n_obs, n_state, dtype, ring, stages,
           sweep)
    if key not in _OCCUPANCY:
        lib = build.load_library("lanes_adjoint")
        fn = (lib.metran_lanes_adjoint_occupancy_f64
              if dtype == torch.float64
              else lib.metran_lanes_adjoint_occupancy_f32)
        blocks = ctypes.c_int(0)
        err = fn(n_obs, n_state, ring, sweep, stages, ctypes.byref(blocks))
        build.check(lib, err, "lanes_adjoint occupancy")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def chain_occupancy(n_obs: int, n_state: int, dtype: torch.dtype,
                    update_warps: int) -> int:
    """Blocks of K3 the current card keeps resident per SM at this shape
    and count of update warps (CUDA's occupancy calculator; builds the
    kernels)."""
    import ctypes

    key = ("filter", torch.cuda.current_device(), n_obs, n_state, dtype,
           update_warps)
    if key not in _OCCUPANCY:
        lib = build.load_library("lanes_filter")
        fn = (lib.metran_lanes_filter_occupancy_f64
              if dtype == torch.float64
              else lib.metran_lanes_filter_occupancy_f32)
        blocks = ctypes.c_int(0)
        err = fn(n_obs, n_state, update_warps, ctypes.byref(blocks))
        build.check(lib, err, "lanes_filter occupancy")
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


class ChainShape(NamedTuple):
    """A launch of K3's chain kernel: U update warps beside the chain
    warp (0: the chain warp alone, one warp a lane)."""

    update_warps: int


def chain_shape(lanes: int, n_obs: int, n_state: int, dtype: torch.dtype,
                device) -> ChainShape:
    """The shape K3 launches ``lanes`` lanes with: three update warps while
    every such block is resident on the card (SMs times the occupancy
    calculator's blocks: four warps a lane, a few lanes an SM, where the
    chain's latency is the time); past that the chain warp alone (many lanes
    an SM, where instruction issue is: the update warps' handoffs cost more
    than they hide)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    most = max(UPDATE_WARPS)
    with torch.cuda.device(device):
        resident = sms * chain_occupancy(n_obs, n_state, dtype, most)
    return ChainShape(most if lanes <= resident else 0)


class RingShape(NamedTuple):
    """A launch of K4's ring kernel: R replay warps, D ring slots (R or
    R + 1), the sweep warps, and the records staged in shared memory (2:
    a step ahead, 1: after the step before, 0: read in the ring)."""

    ring: int
    depth: int
    sweep: int
    stages: int


def ring_geometry(lanes: int, t_steps: int, seg: int, n_obs: int,
                  n_state: int, dtype: torch.dtype, device) -> RingShape:
    """The shape K4 launches ``lanes`` lanes with.  The most staged
    records (two, one, none) that fit shared memory beside one replay
    warp; R the most replay warps (up to :data:`RING_MAX` and the
    segments) whose layout fits, with :data:`SWEEP_WARPS` sweep warps
    where two records are staged (else one), while every such block is
    resident on the card (SMs times the occupancy calculator's blocks).  Past that, the :data:`WIDE` shape
    that takes the fewest waves of resident blocks, then the most staged
    records, then the most replay warps.  D is R + 1 slots below
    :data:`RING_MAX` replay warps (with one, the replay would otherwise
    wait for the sweep to free the only slot) and R at it (the spare bought
    nothing there), at most the segments and what :data:`RING_BUDGET` and
    :data:`RING_FREE_SHARE` of the card's free memory hold (at least
    one), and R at most D."""
    item = torch.finfo(dtype).bits // 8
    n_seg = max(1, -(-t_steps // seg))
    room = MAX_SMEM - ADJOINT_STATIC_SMEM
    stages = max(k for k in (0, 1, 2)
                 if k == 0 or _ring_layout(n_obs, n_state, 1, k, item) <= room)
    ring = max(r for r in range(1, RING_MAX + 1)
               if _ring_layout(n_obs, n_state, r, stages, item) <= room)
    ring = min(ring, n_seg)
    props = torch.cuda.get_device_properties(device)
    sms = props.multi_processor_count
    sweep = SWEEP_WARPS if stages == 2 else 1
    with torch.cuda.device(device):
        resident = sms * adjoint_occupancy(n_obs, n_state, dtype, ring,
                                           stages, sweep)
        if lanes > resident:
            best = None
            for r, sw, st in WIDE:
                r, st = min(r, ring), min(st, stages)
                waves = -(-lanes // max(1, sms * adjoint_occupancy(
                    n_obs, n_state, dtype, r, st, sw)))
                if best is None or (waves, -st, -r) < best[0]:
                    best = ((waves, -st, -r), r, sw, st)
            _, ring, sweep, stages = best
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
    budget = min(RING_BUDGET, int(free * RING_FREE_SHARE))
    slot = lanes * seg * record_stride(n_obs, n_state) * item
    spare = 1 if ring < RING_MAX else 0
    depth = min(ring + spare, n_seg, max(1, budget // slot))
    return RingShape(min(ring, depth), depth, sweep, stages)


def ring_bytes(lanes: int, seg: int, n_obs: int, n_state: int,
               dtype: torch.dtype, depth: int) -> int:
    """Device memory of K4's ring: ``depth`` slots of ``seg`` records a
    lane."""
    return (lanes * depth * seg * record_stride(n_obs, n_state)
            * (torch.finfo(dtype).bits // 8))


def _check(phi, q, z, r, y, mask, lane_map, seg):
    """Validate the common inputs; returns ``(L, D, T, N, n, seg, n_seg,
    lane_map)`` with ``seg`` and ``lane_map`` defaulted."""
    dtype = phi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the lanes filter takes float32/float64, got {dtype}")
    if phi.dim() != 2:
        raise ValueError(f"phi must be (n, L), got {tuple(phi.shape)}")
    n, lanes = phi.shape
    if z.dim() != 3 or z.shape[1:] != (n, lanes):
        raise ValueError(f"z must be (N, {n}, {lanes}), got {tuple(z.shape)}")
    big_n = z.shape[0]
    if y.dim() != 3 or y.shape[2] != big_n:
        raise ValueError(f"y must be (D, T, {big_n}), got {tuple(y.shape)}")
    d_lanes, t_steps = y.shape[:2]
    for name, t, shape in (("q", q, (n, lanes)), ("r", r, (big_n, lanes)),
                           ("mask", mask, tuple(y.shape))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("z", z), ("r", r), ("y", y)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if lane_map is None:
        if d_lanes != lanes:
            raise ValueError(
                f"{lanes} lanes over {d_lanes} data lanes need a lane_map")
        lane_map = torch.arange(lanes, dtype=torch.int32, device=phi.device)
    if lane_map.dtype != torch.int32 or tuple(lane_map.shape) != (lanes,):
        raise ValueError(
            f"lane_map must be int32 ({lanes},), got {lane_map.dtype} "
            f"{tuple(lane_map.shape)}")
    devices = {t.device for t in (phi, q, z, r, y, mask, lane_map)}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devices))}")
    if lanes and (int(lane_map.min()) < 0 or int(lane_map.max()) >= d_lanes):
        raise ValueError(f"lane_map indexes outside the {d_lanes} data lanes")
    seg = t_steps if seg is None else int(seg)
    if seg < 1:
        seg = 1
    n_seg = -(-t_steps // seg)
    return lanes, d_lanes, t_steps, big_n, n, seg, n_seg, lane_map


def _check_cuda(kind, phi, big_n, n):
    if phi.device.type != "cuda":
        raise ValueError(
            f"the lanes-{kind} kernel runs on CUDA tensors, got {phi.device}")
    smem = smem_bytes(kind, big_n, n, phi.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"(N={big_n}, n={n}) at {phi.dtype} needs {smem} bytes of "
            f"shared memory per block; the kernel takes at most {MAX_SMEM}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------
# K3: the forward filter
# ----------------------------------------------------------------------
def lanes_filter(phi, q, z, r, y, mask, lane_map=None, seg=None,
                 keep_bounds: bool = False) -> LanesFilterResult:
    """The masked sequential filter of every lane (see the module doc).

    ``seg`` (default T) is the segment length of the boundaries.
    """
    _check(phi, q, z, r, y, mask, lane_map, seg)
    if phi.device.type == "cpu":
        return lanes_filter_plain(phi, q, z, r, y, mask, lane_map, seg,
                                  keep_bounds)
    return lanes_filter_kernel(phi, q, z, r, y, mask, lane_map, seg,
                               keep_bounds)


def lanes_filter_kernel(phi, q, z, r, y, mask, lane_map=None, seg=None,
                        keep_bounds: bool = False) -> LanesFilterResult:
    """Launch K3's chain kernel (CUDA tensors only; raises otherwise, and
    when the kernel cannot build, take the shape or launch), with
    :func:`chain_shape`'s update warps."""
    lanes, _, t_steps, big_n, n, seg, n_seg, lane_map = _check(
        phi, q, z, r, y, mask, lane_map, seg)
    _check_cuda("filter", phi, big_n, n)
    if big_n > CHAIN_MAX_SERIES:
        raise ValueError(f"the lanes filter takes at most "
                         f"{CHAIN_MAX_SERIES} series a lane, got {big_n}")
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map)]
    new = dict(dtype=phi.dtype, device=phi.device)
    sigma = torch.empty((t_steps, lanes), **new)
    detf = torch.empty((t_steps, lanes), **new)
    mean = torch.empty((n, lanes), **new)
    cov = torch.empty((n, n, lanes), **new)
    bm = bc = None
    if keep_bounds:
        bm = torch.empty((n_seg, n, lanes), **new)
        bc = torch.empty((n_seg, n, n, lanes), **new)
    shape = (chain_shape(lanes, big_n, n, phi.dtype, phi.device)
             if lanes else ChainShape(0))
    lib = build.load_library("lanes_filter")
    fn = (lib.metran_lanes_filter_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_filter_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], sigma.data_ptr(),
                 detf.data_ptr(), mean.data_ptr(), cov.data_ptr(), _ptr(bm),
                 _ptr(bc), lanes, t_steps, big_n, n, seg,
                 shape.update_warps, _stream(phi))
    build.check(lib, err, "lanes_filter")
    if lanes:
        build.count_launch("lanes_filter")
    return LanesFilterResult(sigma, detf, mean, cov, bm, bc)


def lanes_filter_warp_kernel(phi, q, z, r, y, mask, lane_map=None, seg=None,
                             keep_bounds: bool = False) -> LanesFilterResult:
    """Launch K3's warp kernel (``csrc/lanes_filter_warp.cu``), the chain
    kernel's bit-for-bit oracle (CUDA tensors only; raises otherwise).
    Counted as ``lanes_filter_warp``, apart from the paths' launches."""
    lanes, _, t_steps, big_n, n, seg, n_seg, lane_map = _check(
        phi, q, z, r, y, mask, lane_map, seg)
    _check_cuda("filter_warp", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map)]
    new = dict(dtype=phi.dtype, device=phi.device)
    sigma = torch.empty((t_steps, lanes), **new)
    detf = torch.empty((t_steps, lanes), **new)
    mean = torch.empty((n, lanes), **new)
    cov = torch.empty((n, n, lanes), **new)
    bm = bc = None
    if keep_bounds:
        bm = torch.empty((n_seg, n, lanes), **new)
        bc = torch.empty((n_seg, n, n, lanes), **new)
    lib = build.load_library("lanes_filter_warp")
    fn = (lib.metran_lanes_filter_warp_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_filter_warp_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], sigma.data_ptr(),
                 detf.data_ptr(), mean.data_ptr(), cov.data_ptr(), _ptr(bm),
                 _ptr(bc), lanes, t_steps, big_n, n, seg, _stream(phi))
    build.check(lib, err, "lanes_filter_warp")
    if lanes:
        build.count_launch("lanes_filter_warp")
    return LanesFilterResult(sigma, detf, mean, cov, bm, bc)


def segment(y, mask, seg: int, dtype):
    """Zero-pad ``(y, mask as float)`` to a multiple of ``seg`` steps
    along axis 0 and reshape to ``(n_seg, seg, ...)``: the padded steps
    are all-masked no-ops (``metran_tpu/ops/lanes.py::_segment``)."""
    t_steps = y.shape[0]
    y = y.to(dtype)
    maskf = mask.to(dtype)
    pad = (-t_steps) % seg
    if pad:
        y = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
        maskf = torch.cat(
            [maskf, maskf.new_zeros((pad,) + tuple(maskf.shape[1:]))])
    return (y.reshape(-1, seg, *y.shape[1:]),
            maskf.reshape(-1, seg, *maskf.shape[1:]))


class _Plain(NamedTuple):
    """What the plain versions precompute once per call: the lane
    constants as views, and each padded step's data as per-slot rows with
    host flags (0: no lane observes the slot, an exact no-op; 1: some
    do; 2: all do, so no select is needed)."""

    phi_a: torch.Tensor  # (n, 1, L)
    phi_b: torch.Tensor  # (1, n, L)
    qdiag: torch.Tensor  # (n, n, L): eye * q
    eye: torch.Tensor  # (n, n, 1)
    z_rows: list  # N x (n, L)
    zb_rows: list  # N x (1, n, L)
    r_rows: Optional[list]  # N x (L,), None when r == 0
    y_rows: list  # n_seg*seg x N x (L,)
    obs: list  # n_seg*seg x (N, L) bool
    flags: list  # n_seg*seg x N


def _plain_setup(phi, q, z, r, y, mask, lane_map, seg):
    n = phi.shape[0]
    dtype = phi.dtype
    eye = torch.eye(n, dtype=dtype, device=phi.device)[:, :, None]
    idx = lane_map.long()
    y_seg, m_seg = segment(y[idx].permute(1, 2, 0),
                           mask[idx].permute(1, 2, 0), seg, dtype)
    obs = (m_seg > 0).flatten(0, 1)  # (n_seg*seg, N, L)
    flags = (obs.any(-1).to(torch.int8) + obs.all(-1).to(torch.int8)).tolist()
    r_rows = None if not bool((r != 0).any()) else list(r.unbind(0))
    return _Plain(
        phi[:, None, :], phi[None, :, :], eye * q[None], eye,
        list(z.unbind(0)), [z_i[None] for z_i in z.unbind(0)], r_rows,
        [y_t.unbind(0) for y_t in y_seg.flatten(0, 1).unbind(0)],
        list(obs.unbind(0)), flags)


def _predict(c: _Plain, phi, mean, cov):
    """The diagonal predict (``_predict_step``)."""
    return phi * mean, c.phi_a * cov * c.phi_b + c.qdiag


def _update(c: _Plain, m, p, t: int, keep_res=False):
    """The masked sequential updates of step ``t`` on the predicted
    ``(m, p)`` (``_adj_series_update``).  Returns ``(mean, cov, sigma_t,
    detf_t, residuals)``, the residuals ``[(slot, flag, d, f_safe, v),
    ...]`` of the observed slots when ``keep_res``."""
    obs_t, y_t = c.obs[t], c.y_rows[t]
    vs, fs, rows, res = [], [], [], []
    for i, flag in enumerate(c.flags[t]):
        if not flag:
            continue
        z_i = c.z_rows[i]
        v = y_t[i] - torch.linalg.vecdot(z_i, m, dim=0)
        d = torch.linalg.vecdot(p, c.zb_rows[i], dim=1)
        f = torch.linalg.vecdot(z_i, d, dim=0)
        if c.r_rows is not None:
            f = f + c.r_rows[i]
        f_safe = torch.where(obs_t[i], f, 1.0) if flag == 1 else f
        k = d / f_safe
        m_new = m + k * v
        p_new = p - k[:, None] * k[None] * f_safe
        if flag == 1:
            m = torch.where(obs_t[i], m_new, m)
            p = torch.where(obs_t[i], p_new, p)
        else:
            m, p = m_new, p_new
        vs.append(v)
        fs.append(f_safe)
        rows.append(i)
        if keep_res:
            res.append((i, flag, d, f_safe, v))
    if rows:
        v = torch.stack(vs)
        f = torch.stack(fs)
        sig = torch.where(obs_t[rows], v * v / f, 0.0).sum(0)
        det = torch.log(f).sum(0)  # masked lanes have f_safe = 1
    else:
        sig = det = torch.zeros_like(m[0])
    return m, p, sig, det, res


def _filter_step(c: _Plain, phi, mean, cov, t: int, keep_res=False):
    """Step ``t``: :func:`_predict`, then :func:`_update`."""
    m, p = _predict(c, phi, mean, cov)
    return _update(c, m, p, t, keep_res)


def lanes_filter_plain(phi, q, z, r, y, mask, lane_map=None, seg=None,
                       keep_bounds: bool = False) -> LanesFilterResult:
    """The same function in PyTorch ops: a Python loop over steps and
    slots, each slot update batched over the lanes (the JAX lane-layout
    step, ``_adj_series_update``); differentiable by torch autograd."""
    lanes, _, t_steps, _, n, seg, n_seg, lane_map = _check(
        phi, q, z, r, y, mask, lane_map, seg)
    dtype = phi.dtype
    c = _plain_setup(phi, q, z, r, y, mask, lane_map, seg)
    m = torch.zeros((n, lanes), dtype=dtype, device=phi.device)
    p = c.eye.expand(n, n, lanes)
    sigs, dets, bm, bc = [], [], [], []
    for t in range(n_seg * seg):
        if keep_bounds and t % seg == 0:
            bm.append(m)
            bc.append(p)
        m, p, sig, det, _ = _filter_step(c, phi, m, p, t)
        sigs.append(sig)
        dets.append(det)
    empty = torch.zeros((0, lanes), dtype=dtype, device=phi.device)
    sigma = torch.stack(sigs)[:t_steps] if sigs else empty
    detf = torch.stack(dets)[:t_steps] if dets else empty
    if not keep_bounds:
        return LanesFilterResult(sigma, detf, m, p)
    bounds_m = (torch.stack(bm) if bm
                else torch.zeros((0, n, lanes), dtype=dtype, device=phi.device))
    bounds_c = (torch.stack(bc) if bc else
                torch.zeros((0, n, n, lanes), dtype=dtype, device=phi.device))
    return LanesFilterResult(sigma, detf, m, p, bounds_m, bounds_c)


# ----------------------------------------------------------------------
# K4: the closed-form adjoint
# ----------------------------------------------------------------------
def _check_adjoint(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                   bounds_cov, sb, db):
    out = _check(phi, q, z, r, y, mask, lane_map, seg)
    lanes, _, t_steps, _, n, _, n_seg, _ = out
    for name, t, shape in (
            ("bounds_mean", bounds_mean, (n_seg, n, lanes)),
            ("bounds_cov", bounds_cov, (n_seg, n, n, lanes)),
            ("sb", sb, (t_steps, lanes)), ("db", db, (t_steps, lanes))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != phi.dtype:
            raise TypeError(f"{name} is {t.dtype}, phi is {phi.dtype}")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, phi on {phi.device}")
    return out


def lanes_adjoint(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                  bounds_cov, sb, db) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(phibar, qbar)``, each (n, L): the cotangents of ``phi`` and
    ``q`` given those of ``(sigma, detf)`` (``sb``, ``db``, (T, L)) and
    K3's segment boundaries at the same ``seg``."""
    args = (phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov,
            sb, db)
    _check_adjoint(*args)
    if phi.device.type == "cpu":
        return lanes_adjoint_plain(*args)
    return lanes_adjoint_kernel(*args)


def lanes_adjoint_kernel(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                         bounds_cov, sb, db):
    """Launch K4's ring kernel (CUDA tensors only).  Its ring, D slots of
    ``seg`` records (:func:`record_stride`) per lane, is allocated here
    (:func:`ring_geometry`)."""
    lanes, _, t_steps, big_n, n, seg, n_seg, lane_map = _check_adjoint(
        phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov, sb,
        db)
    _check_cuda("adjoint", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map,
                                     bounds_mean, bounds_cov, sb, db)]
    new = dict(dtype=phi.dtype, device=phi.device)
    shape = (ring_geometry(lanes, t_steps, seg, big_n, n, phi.dtype,
                           phi.device)
             if lanes else RingShape(1, 1, 1, 0))
    records = torch.empty((lanes, shape.depth, seg,
                           record_stride(big_n, n)), **new)
    phibar = torch.empty((n, lanes), **new)
    qbar = torch.empty((n, lanes), **new)
    lib = build.load_library("lanes_adjoint")
    fn = (lib.metran_lanes_adjoint_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_adjoint_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], records.data_ptr(),
                 phibar.data_ptr(), qbar.data_ptr(), lanes, t_steps, big_n,
                 n, seg, shape.ring, shape.depth, shape.sweep, shape.stages,
                 _stream(phi))
    build.check(lib, err, "lanes_adjoint")
    if lanes:
        build.count_launch("lanes_adjoint")
    return phibar, qbar


def lanes_adjoint_warp_kernel(phi, q, z, r, y, mask, lane_map, seg,
                              bounds_mean, bounds_cov, sb, db):
    """Launch K4's warp kernel (``csrc/lanes_adjoint_warp.cu``), the ring
    kernel's bit-for-bit oracle (CUDA tensors only; raises otherwise).
    Counted as ``lanes_adjoint_warp``, apart from the paths' launches.
    Its replay scratch, ``seg * scratch_stride(N, n)`` values per lane,
    is allocated here."""
    lanes, _, t_steps, big_n, n, seg, n_seg, lane_map = _check_adjoint(
        phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov, sb,
        db)
    _check_cuda("adjoint_warp", phi, big_n, n)
    args = [t.contiguous() for t in (phi, q, z, r, y, mask, lane_map,
                                     bounds_mean, bounds_cov, sb, db)]
    new = dict(dtype=phi.dtype, device=phi.device)
    scratch = torch.empty((lanes, seg, scratch_stride(big_n, n)), **new)
    phibar = torch.empty((n, lanes), **new)
    qbar = torch.empty((n, lanes), **new)
    lib = build.load_library("lanes_adjoint_warp")
    fn = (lib.metran_lanes_adjoint_warp_f64 if phi.dtype == torch.float64
          else lib.metran_lanes_adjoint_warp_f32)
    with torch.cuda.device(phi.device):
        err = fn(*[t.data_ptr() for t in args], scratch.data_ptr(),
                 phibar.data_ptr(), qbar.data_ptr(), lanes, t_steps, big_n,
                 n, seg, _stream(phi))
    build.check(lib, err, "lanes_adjoint_warp")
    if lanes:
        build.count_launch("lanes_adjoint_warp")
    return phibar, qbar


def _series_bwd(u, s, z_i, zb_i, d, f, v, sb_t, db_t):
    """Adjoint of one observed rank-1 update: from the adjoints ``(u,
    S)`` of the post-update ``(m, P)`` to those of the pre-update
    (``zb_i`` is ``z_i[None]``)."""
    ud = torch.linalg.vecdot(u, d, dim=0)
    sd = torch.linalg.vecdot(s, d[None], dim=1)  # S d
    std = torch.linalg.vecdot(s, d[:, None], dim=0)  # S' d
    dsd = torch.linalg.vecdot(d, sd, dim=0)
    ff = f * f
    vbar = 2.0 * sb_t * v / f + ud / f
    fbar = -sb_t * v * v / ff + db_t / f + dsd / ff - ud * v / ff
    dvec = -(sd + std) / f + u * (v / f) + fbar * z_i
    return u - vbar * z_i, s + dvec[:, None, :] * zb_i


def lanes_adjoint_plain(phi, q, z, r, y, mask, lane_map, seg, bounds_mean,
                        bounds_cov, sb, db):
    """The same reverse sweep in PyTorch ops (``_terms_adjoint_bwd``)."""
    lanes, _, t_steps, _, n, seg, n_seg, lane_map = _check_adjoint(
        phi, q, z, r, y, mask, lane_map, seg, bounds_mean, bounds_cov, sb,
        db)
    dtype = phi.dtype
    with torch.no_grad():
        c = _plain_setup(phi, q, z, r, y, mask, lane_map, seg)
        pad = n_seg * seg - t_steps
        sb_seg = torch.cat([sb, sb.new_zeros((pad, lanes))]).reshape(
            n_seg, seg, lanes)
        db_seg = torch.cat([db, db.new_zeros((pad, lanes))]).reshape(
            n_seg, seg, lanes)
        u = torch.zeros((n, lanes), dtype=dtype, device=phi.device)
        s = torch.zeros((n, n, lanes), dtype=dtype, device=phi.device)
        phibar, qbar = torch.zeros_like(u), torch.zeros_like(u)
        for g in range(n_seg - 1, -1, -1):
            # replay the segment from its boundary, keeping residuals
            m, p = bounds_mean[g], bounds_cov[g]
            stored = []
            for k in range(seg):
                m0, p0 = m, p
                m, p, _, _, res = _filter_step(c, phi, m, p, g * seg + k,
                                               keep_res=True)
                stored.append((m0, p0, res))
            for k in range(seg - 1, -1, -1):
                m0, p0, res = stored[k]
                sb_t, db_t = sb_seg[g, k], db_seg[g, k]
                obs_t = c.obs[g * seg + k]
                for i, flag, d, f, v in reversed(res):
                    u_new, s_new = _series_bwd(u, s, c.z_rows[i],
                                               c.zb_rows[i], d, f, v, sb_t,
                                               db_t)
                    if flag == 1:
                        u = torch.where(obs_t[i], u_new, u)
                        s = torch.where(obs_t[i], s_new, s)
                    else:
                        u, s = u_new, s_new
                # predict backward: (u, S) are now the adjoints of the
                # predicted moments; (m0, P0) the pre-predict carry
                sc = s * p0
                phibar = phibar + (u * m0
                                   + torch.linalg.vecdot(sc, c.phi_b, dim=1)
                                   + torch.linalg.vecdot(sc, c.phi_a, dim=0))
                qbar = qbar + torch.sum(s * c.eye, dim=1)
                u = u * phi
                s = s * c.phi_a * c.phi_b
    return phibar, qbar
