"""Per-fit optimizer telemetry (deviance curve, gradients, stop reason).

Port of ``metran_tpu/obs/telemetry.py::FitTelemetry``, the only part of
the JAX package's ``obs/`` the port has yet (the rest is ROADMAP A7).
:class:`FitTelemetry` is the flight recorder ``run_lbfgs`` fills as it
drives the chunked L-BFGS loop (``models/solver.py``): the deviance
curve and gradient norms at every host-side checkpoint (one per chunk of
up to 20 iterations), true objective-evaluation counts, line-search
stall detection, the precise stop reason, and — when the objective went
non-finite — the divergence diagnosis.  ``JaxSolve`` attaches it as
``solver.telemetry`` and ``Metran.fit_report()`` surfaces the one-line
summary.

Stop reasons (:attr:`FitTelemetry.stop_reason`):

- ``"gradient"`` — gradient-norm test fired (``tol``);
- ``"floor"`` — scipy-factr-style relative-improvement test fired
  (``ftol``; the normal float32 stop);
- ``"maxiter"`` — iteration budget exhausted, not converged;
- ``"diverged"`` — objective became non-finite (see ``divergence``);
- ``"worse_than_start"`` — a stopping test fired at a value worse than
  the starting point (line-search failure creep; never reported as
  success);
- ``"init_nonfinite"`` — the objective was already non-finite at the
  initial parameters.

Host-side and dependency-free: recording happens between chunks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FitTelemetry:
    """One optimization run's recorded trajectory (see module docstring).

    ``checkpoints`` holds one record per host-side convergence check —
    ``{"iters", "value", "grad_norm", "nfev"[, "wall_s"]}`` —
    chunk-granular, so a 200-iteration fit carries ~10 records, not
    200.  ``grad_engine`` names the gradient engine the run
    differentiated with (``"adjoint"`` = the closed-form Kalman-score
    VJP, ``"autodiff"`` = torch autograd through the plain filter), so
    the per-iteration wall times — forward and backward passes of each
    chunk — are attributable to the backward pass that actually ran.
    """

    checkpoints: List[Dict] = field(default_factory=list)
    n_iters: int = 0
    nfev: int = 0
    converged: Optional[bool] = None
    stop_reason: Optional[str] = None
    divergence: Optional[str] = None
    linesearch_stalls: int = 0
    value0: Optional[float] = None
    value: Optional[float] = None
    grad_engine: Optional[str] = None

    def record_start(self, value0: float) -> None:
        self.value0 = float(value0)

    def record_grad_engine(self, engine: Optional[str]) -> None:
        """Name the gradient engine this run differentiates with."""
        self.grad_engine = None if engine is None else str(engine)

    def record_checkpoint(self, iters: int, value: float,
                          grad_norm: float, nfev: int,
                          wall_s: Optional[float] = None) -> None:
        """One host-side convergence check (between device chunks).

        A checkpoint whose value failed to improve on its predecessor
        counts as a **line-search stall** — the signature of zoom
        line-search failure fallbacks creeping along a flat or
        degenerate objective.  ``wall_s`` is the chunk's host-measured
        wall time (device forward + backward work included).
        """
        if self.checkpoints and not (
            float(value) < self.checkpoints[-1]["value"]
        ):
            self.linesearch_stalls += 1
        rec = {
            "iters": int(iters),
            "value": float(value),
            "grad_norm": float(grad_norm),
            "nfev": int(nfev),
        }
        if wall_s is not None:
            rec["wall_s"] = round(float(wall_s), 6)
        self.checkpoints.append(rec)
        self.n_iters = int(iters)
        self.nfev = int(nfev)
        self.value = float(value)

    def record_stop(self, reason: str, converged: bool,
                    divergence: Optional[str] = None) -> None:
        self.stop_reason = str(reason)
        self.converged = bool(converged)
        if divergence is not None:
            self.divergence = str(divergence)

    # -- read -----------------------------------------------------------
    def deviance_curve(self) -> List[float]:
        """Objective value at each checkpoint (chunk-granular)."""
        return [c["value"] for c in self.checkpoints]

    def grad_norms(self) -> List[float]:
        """Gradient l2 norm at each checkpoint."""
        return [c["grad_norm"] for c in self.checkpoints]

    def improvement(self) -> Optional[float]:
        """Total deviance decrease start-to-stop (None before a run)."""
        if self.value0 is None or self.value is None:
            return None
        return self.value0 - self.value

    def iteration_wall_s(self) -> Optional[float]:
        """Mean wall seconds per L-BFGS iteration over the timed
        chunks (None when no chunk carried a wall time).

        The FIRST timed chunk is excluded whenever a later one exists:
        it carries the one-time set-up of the run (on the card, the
        kernels' first build and load), which would inflate a
        per-engine backward-cost comparison.  Single-chunk fits have
        nothing else to report, so their number is returned as-is.
        """
        timed = [c for c in self.checkpoints if "wall_s" in c]
        if not timed or self.n_iters <= 0:
            return None
        if len(timed) >= 2:
            iters = timed[-1]["iters"] - timed[0]["iters"]
            if iters > 0:
                return sum(c["wall_s"] for c in timed[1:]) / iters
        return timed[0]["wall_s"] / max(timed[0]["iters"], 1)

    def snapshot(self) -> Dict:
        """JSON-ready dict (bench/report consumption)."""
        return {
            "n_iters": self.n_iters,
            "nfev": self.nfev,
            "converged": self.converged,
            "stop_reason": self.stop_reason,
            "divergence": self.divergence,
            "linesearch_stalls": self.linesearch_stalls,
            "value0": self.value0,
            "value": self.value,
            "grad_engine": self.grad_engine,
            "iteration_wall_s": self.iteration_wall_s(),
            "checkpoints": [dict(c) for c in self.checkpoints],
        }

    def summary(self) -> str:
        """One line for ``fit_report()``."""
        if self.stop_reason is None:
            return "no run recorded"
        grad = (
            f"{self.checkpoints[-1]['grad_norm']:.3g}"
            if self.checkpoints else "n/a"
        )
        imp = self.improvement()
        parts = [
            f"stop={self.stop_reason}",
            f"iters={self.n_iters}",
            f"nfev={self.nfev}",
            f"|grad|={grad}",
        ]
        if self.grad_engine:
            parts.insert(0, f"grad_engine={self.grad_engine}")
        it_wall = self.iteration_wall_s()
        if it_wall is not None:
            parts.append(f"s/iter={it_wall:.3g}")
        if imp is not None:
            parts.append(f"ddev={imp:.6g}")
        if self.linesearch_stalls:
            parts.append(f"linesearch_stalls={self.linesearch_stalls}")
        if self.divergence:
            parts.append(f"divergence={self.divergence}")
        return " ".join(parts)


__all__ = ["FitTelemetry"]
