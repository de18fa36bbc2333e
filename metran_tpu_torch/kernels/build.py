"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a``
(Hopper) into a shared library of its own with a plain C interface,
loaded with :mod:`ctypes` — one ``nvcc`` process per source, all started
together.  No PyTorch headers are involved, so a build takes seconds.

A library is named by a hash of its source and the flags and lives in
``kernels/build/`` (git-ignored); a build happens once per checkout at
first use.

There is no fallback: without ``nvcc`` or when a source does not
compile, :func:`load_library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
#: what the last build printed:
#: ``{"seconds": float, "ptxas": {src: str}, "paths": {stem: str}}``
build_info: dict = {}

# ----------------------------------------------------------------------
# launch counters: each wrapper adds one where it launches its kernel
# ----------------------------------------------------------------------
_count_lock = threading.Lock()
LAUNCHES = {"joint_filter_append": 0, "joint_filter_store": 0,
            "forecast_moments": 0, "lanes_filter": 0, "lanes_adjoint": 0,
            "lanes_smooth_bwd": 0, "lanes_forward": 0, "lanes_sample": 0,
            "rts_smooth": 0, "sqrt_filter": 0, "sqrt_filter_gated": 0,
            "sqrt_smooth": 0, "joint_adjoint": 0, "gated_filter": 0,
            "detect": 0, "gated_filter_robust": 0, "sqrt_filter_robust": 0,
            "steady_filter": 0, "dare": 0, "arena_update": 0,
            "arena_update_sqrt": 0, "arena_steady_update": 0,
            "arena_forecast": 0, "parallel_filter": 0, "parallel_smooth": 0,
            "sqrt_parallel_filter": 0, "sqrt_parallel_smooth": 0,
            "parallel_filter_total": 0, "parallel_filter_carry": 0,
            "parallel_filter_prefix": 0, "parallel_smooth_total": 0,
            "parallel_smooth_carry": 0, "parallel_smooth_prefix": 0}


#: launches of the kernels kept beside the port's only as their
#: bit-for-bit oracles (K1's and K9's block kernels, K3's and K4's warp
#: kernels),
#: which no path calls; apart from :data:`LAUNCHES` and not reset with it
ORACLE_LAUNCHES = {"joint_filter_append_block": 0,
                   "joint_filter_store_block": 0, "sqrt_filter_block": 0,
                   "sqrt_filter_gated_block": 0,
                   "sqrt_filter_robust_block": 0, "lanes_adjoint_warp": 0,
                   "lanes_filter_warp": 0}


def count_launch(name: str) -> None:
    with _count_lock:
        (ORACLE_LAUNCHES if name in ORACLE_LAUNCHES else LAUNCHES)[name] += 1


def oracle_launches() -> dict:
    with _count_lock:
        return dict(ORACLE_LAUNCHES)


def reset_launches() -> None:
    with _count_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> dict:
    with _count_lock:
        return dict(LAUNCHES)


# ----------------------------------------------------------------------
def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    """Where ``src``'s shared library lives: named by a hash of the
    source, the headers and the flags."""
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together; returns ``{stem: library path}``.

    Each ``nvcc`` writes a temporary file of its own that is renamed
    into place, so concurrent builders never see a partial library.
    """
    libs = {src.stem: library_path(src) for src in sources()}
    todo = {src: libs[src.stem] for src in sources()
            if not libs[src.stem].exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, str(src), "-o", str(tmp)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    ptxas, failed = {}, []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        ptxas[src.name] = text
        if proc.returncode == 0:
            tmp.replace(out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_info.clear()
    build_info.update(seconds=time.perf_counter() - t0, ptxas=ptxas,
                      paths={stem: str(p) for stem, p in libs.items()})
    return libs


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double

#: per source, its entry points (each in an ``_f32`` and an ``_f64``
#: instantiation): base name and argument types
_SIGNATURES = {
    # the warp kernel: phi, q, z, r, mean0, cov0, y, mask, mean, cov,
    # sigma, detf, bounds_mean, bounds_cov, B, k, N, S, seg, W, G, stream;
    # its store mode: phi, q, z, r, mean0, cov0, y, mask, mean_p, cov_p,
    # mean_f, cov_f, sigma, detf, B, k, N, S, W, G, stream; the block
    # kernel (the oracle) the same without W and G; one model's bytes:
    # N, S; the warp kernel's blocks resident a SM: N, S, mode, W, G,
    # blocks
    "joint_filter": (
        ("metran_joint_filter", [_PTR] * 14 + [_INT] * 7 + [_PTR]),
        ("metran_joint_filter_store", [_PTR] * 14 + [_INT] * 6 + [_PTR]),
        ("metran_joint_filter_block", [_PTR] * 14 + [_INT] * 5 + [_PTR]),
        ("metran_joint_filter_store_block",
         [_PTR] * 14 + [_INT] * 4 + [_PTR]),
        ("metran_joint_filter_model_bytes", [_INT] * 2),
        ("metran_joint_filter_occupancy", [_INT] * 5 + [_PTR]),
    ),
    # phi, q, z, r, mean0, cov0, y, mask, armed, thresh, mean, cov, sigma,
    # detf, zscore, verdict, B, k, N, S, policy, stream; and the robust
    # modes: phi, q, z, r, mean0, cov0, y, mask, armed, rail_lo, rail_hi,
    # quantum, scale, nu, tol, nonconv_tol, c_floor, mean, cov, sigma,
    # detf, zscore, verdict, iters, B, k, N, S, likelihood, stream
    "gated_filter": (
        ("metran_gated_filter",
         [_PTR] * 9 + [_DBL] + [_PTR] * 6 + [_INT] * 5 + [_PTR]),
        ("metran_gated_filter_robust",
         [_PTR] * 13 + [_DBL] * 4 + [_PTR] * 7 + [_INT] * 5 + [_PTR]),
    ),
    # state, zs, mask, armed, state_out, counts, B, k, N, cusum_k, cusum_h,
    # lam, warm, lb_thresh, nsigma^2, tiny, stream
    "detect": ("metran_detect", [_PTR] * 6 + [_INT] * 3 + [_DBL] * 7
               + [_PTR]),
    # phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db, ring,
    # spill, phibar, qbar, B, T, N, n, seg, factored, R, G, S, stream; and
    # the occupancy query: N, n, R, G, S, spill, blocks
    "joint_adjoint": (
        ("metran_joint_adjoint", [_PTR] * 14 + [_INT] * 9 + [_PTR]),
        ("metran_joint_adjoint_occupancy", [_INT] * 6 + [_PTR]),
    ),
    # phi, q, z, r, mean, cov, horizons, means, variances, B, H, N, S,
    # stream
    "forecast": ("metran_forecast_moments", [_PTR] * 9 + [_INT] * 4 + [_PTR]),
    # the chain kernel: phi, q, z, r, y, mask, lane_map, sigma, detf, mean,
    # cov, bounds_mean, bounds_cov, L, T, N, n, seg, U, stream; its blocks
    # resident a SM: N, n, U, blocks
    "lanes_filter": (
        ("metran_lanes_filter", [_PTR] * 13 + [_INT] * 6 + [_PTR]),
        ("metran_lanes_filter_occupancy", [_INT] * 3 + [_PTR]),
    ),
    # the warp kernel (the oracle): the same arguments without U
    "lanes_filter_warp": ("metran_lanes_filter_warp",
                          [_PTR] * 13 + [_INT] * 5 + [_PTR]),
    # the ring kernel: phi, q, z, r, y, mask, lane_map, bounds_mean,
    # bounds_cov, sb, db, ring, phibar, qbar, L, T, N, n, seg, R, D, S,
    # stages, stream; its blocks resident a SM: N, n, R, S, stages, blocks
    "lanes_adjoint": (
        ("metran_lanes_adjoint", [_PTR] * 14 + [_INT] * 9 + [_PTR]),
        ("metran_lanes_adjoint_occupancy", [_INT] * 5 + [_PTR]),
    ),
    # the warp kernel (the oracle): phi, q, z, r, y, mask, lane_map,
    # bounds_mean, bounds_cov, sb, db, scratch, phibar, qbar, L, T, N, n,
    # seg, stream
    "lanes_adjoint_warp": ("metran_lanes_adjoint_warp",
                           [_PTR] * 14 + [_INT] * 5 + [_PTR]),
    # phi, q, z, r, y, mask, lane_map, bounds_mean, bounds_cov, scratch,
    # mean_s, proj_mean, proj_var, L, T, N, n, seg, want_cov, stream
    "lanes_smooth": ("metran_lanes_smooth",
                     [_PTR] * 13 + [_INT] * 6 + [_PTR]),
    # phi, q, z, r, y, mask, lane_map, t_last, out0, ..., out5, L, T, N,
    # n, mode, stream
    "lanes_forward": ("metran_lanes_forward",
                      [_PTR] * 14 + [_INT] * 5 + [_PTR]),
    # phi, q, z, r, x0, w, e, xs, ystar, L, T, N, n, stream
    "lanes_sample": ("metran_lanes_sample", [_PTR] * 9 + [_INT] * 4 + [_PTR]),
    # phi, mean_f, cov_f, mean_p, cov_p, mean_s, cov_s, L, T, n, stream
    "rts_smoother": ("metran_rts_smoother", [_PTR] * 7 + [_INT] * 3 + [_PTR]),
    # phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, ..., out5,
    # bounds_mean, bounds_chol, L, T, N, n, store, seg, stream; and the
    # gated mode: phi, q, z, r, y, mask, lane_map, mean0, chol0, armed,
    # thresh, mean, chol, sigma, detf, zscore, verdict, L, T, N, n,
    # policy, stream; and the robust modes: phi, q, z, r, y, mask,
    # lane_map, mean0, chol0, armed, rail_lo, rail_hi, quantum, scale, nu,
    # tol, nonconv_tol, c_floor, eps, mean, chol, sigma, detf, zscore,
    # verdict, iters, L, T, N, n, likelihood, stream.  The group kernel's
    # entries take W and G before the stream, the block kernel's (the
    # oracle, its own source) do not; one lane's bytes: N, n; the group
    # kernel's blocks resident a SM: N, n, variant, W, G, blocks
    "sqrt_filter": (
        ("metran_sqrt_filter", [_PTR] * 17 + [_INT] * 8 + [_PTR]),
        ("metran_sqrt_filter_gated",
         [_PTR] * 10 + [_DBL] + [_PTR] * 6 + [_INT] * 7 + [_PTR]),
        ("metran_sqrt_filter_robust",
         [_PTR] * 14 + [_DBL] * 5 + [_PTR] * 7 + [_INT] * 7 + [_PTR]),
        ("metran_sqrt_filter_model_bytes", [_INT] * 2),
        ("metran_sqrt_filter_occupancy", [_INT] * 5 + [_PTR]),
    ),
    "sqrt_filter_block": (
        ("metran_sqrt_filter_block", [_PTR] * 17 + [_INT] * 6 + [_PTR]),
        ("metran_sqrt_filter_gated_block",
         [_PTR] * 10 + [_DBL] + [_PTR] * 6 + [_INT] * 5 + [_PTR]),
        ("metran_sqrt_filter_robust_block",
         [_PTR] * 14 + [_DBL] * 5 + [_PTR] * 7 + [_INT] * 5 + [_PTR]),
    ),
    # phi, q, mean_f, chol_f, mean_p, chol_p, mean_s, chol_s, L, T, n,
    # stream
    "sqrt_smoother": ("metran_sqrt_smoother",
                      [_PTR] * 8 + [_INT] * 3 + [_PTR]),
    # phi, z, kgain, fdiag, real, mean0, y, mask, armed, thresh, mean,
    # sigma, detf, broke, zscore, verdict, horizons, fmeans, H, B, k, N,
    # S, policy, sequential, stream
    "steady_filter": ("metran_steady_filter",
                      [_PTR] * 9 + [_DBL] + [_PTR] * 8 + [_INT] * 7
                      + [_PTR]),
    # phi, q, z, r, p_given, p_pred, p_filt, kgain, fdiag, kgain_seq,
    # fdiag_seq, B, N, S, newton, doubling, stream
    "dare": ("metran_dare", [_PTR] * 11 + [_INT] * 5 + [_PTR]),
    # the K16 families (one signature): mean, fac, t_seen, version, phi,
    # q, z, r, det, rows, y, mask, real, rail_lo, rail_hi, quantum,
    # scale, ok, sigma, detf, zscore, verdict, iters, det_counts,
    # det_stats, conv, horizons, fmeans, fvars, thresh, nu, tol,
    # nonconv_tol, c_floor, eps, steady_tol, cusum_k, cusum_h, lam, warm,
    # lb_thresh, nsigma^2, tiny, min_seen, det_min_seen, validate, mode,
    # G, k, N, S, H, stream
    **{f"arena_{body}": (f"metran_arena_{body}",
                         [_PTR] * 29 + [_DBL] * 14 + [_INT] * 9 + [_PTR])
       for body in ("joint", "gated", "sqrt")},
    # mean, t_seen, version, phi, z, steady, kgain, fdiag, det, rows,
    # real, y, mask, applied, sigma, detf, zscore, verdict, det_counts,
    # det_stats, horizons, fmeans, thresh, cusum_k, cusum_h, lam, warm,
    # lb_thresh, nsigma^2, tiny, min_seen, det_min_seen, policy,
    # sequential, G, k, N, S, H, stream
    "arena_steady": ("metran_arena_steady",
                     [_PTR] * 22 + [_DBL] * 8 + [_INT] * 9 + [_PTR]),
    # mean, fac, phi, q, z, r, rows, horizons, means, variances, G, H, N,
    # S, sqrt, stream
    "arena_forecast": ("metran_arena_forecast",
                       [_PTR] * 10 + [_INT] * 5 + [_PTR]),
    # phi, q, z, r, y, mask, mean_p, cov_p (or chol_p), mean_f, cov_f,
    # sigma, detf, scratch, B, T, N, n, chunk, store, stream (K19, K21);
    # K19's sharded modes: total (phi, q, z, r, y, mask, tot, total, B,
    # T, N, n, chunk, origin, stream), carry (totals, pre, B, S, n,
    # stream) and prefix (phi, q, z, r, y, mask, mean_p, cov_p, mean_f,
    # cov_f, sigma, detf, tot, pre, in_pre, B, T, N, n, chunk, store,
    # origin, stream)
    "pkalman_filter": (
        ("metran_pkalman_filter", [_PTR] * 13 + [_INT] * 6 + [_PTR]),
        ("metran_pkalman_filter_total", [_PTR] * 8 + [_INT] * 6 + [_PTR]),
        ("metran_pkalman_filter_carry", [_PTR] * 2 + [_INT] * 3 + [_PTR]),
        ("metran_pkalman_filter_prefix",
         [_PTR] * 15 + [_INT] * 7 + [_PTR]),
    ),
    "sqrt_pkalman_filter": ("metran_sqrt_pkalman_filter",
                            [_PTR] * 13 + [_INT] * 6 + [_PTR]),
    # phi, mean_f, cov_f, mean_p, cov_p, mean_s, cov_s, scratch, B, T, n,
    # chunk, stream (K20); K22 takes q (the diagonal of Q) after phi;
    # K20's sharded modes: total (phi, mean_f, cov_f, mean_p, cov_p,
    # halo_m, halo_c, tot, total, B, T, n, chunk, origin, stream), carry
    # (totals, pre, B, S, n, stream) and prefix (phi, mean_f, cov_f,
    # mean_p, cov_p, halo_m, halo_c, mean_s, cov_s, tot, pre, in_pre, B,
    # T, n, chunk, origin, stream)
    "pkalman_smoother": (
        ("metran_pkalman_smoother", [_PTR] * 8 + [_INT] * 4 + [_PTR]),
        ("metran_pkalman_smoother_total",
         [_PTR] * 9 + [_INT] * 5 + [_PTR]),
        ("metran_pkalman_smoother_carry",
         [_PTR] * 2 + [_INT] * 3 + [_PTR]),
        ("metran_pkalman_smoother_prefix",
         [_PTR] * 12 + [_INT] * 5 + [_PTR]),
    ),
    "sqrt_pkalman_smoother": ("metran_sqrt_pkalman_smoother",
                              [_PTR] * 9 + [_INT] * 4 + [_PTR]),
}


def load_library(stem: str):
    """The loaded library of ``csrc/<stem>.cu`` (every source is built
    at the first call)."""
    with _lock:
        if not _libs:
            for name, path in build().items():
                lib = ctypes.CDLL(str(path))
                entries = _SIGNATURES[name]
                if isinstance(entries[0], str):
                    entries = (entries,)
                for base, argtypes in entries:
                    for suffix in ("f32", "f64"):
                        fn = getattr(lib, f"{base}_{suffix}")
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                lib.metran_error_string.argtypes = [ctypes.c_int]
                lib.metran_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
        return _libs[stem]


def check(lib, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.metran_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
