"""Which gradient engine a deviance differentiates through.

Only the engine resolution of ``metran_tpu/ops/adjoint.py`` is ported
yet.  The closed-form adjoint itself is kernel K4
(:mod:`metran_tpu_torch.kernels.lanes`), which serves the lane layout
and the batch-layout sequential deviance alike; the batch-layout VJP of
the joint and square-root engines (B7) waits for ROADMAP A7.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import grad_engine as _grad_engine

#: engines the closed-form adjoint covers (the sequential-scan engines;
#: the associative-scan ``parallel`` engines keep autodiff)
ADJOINT_ENGINES = ("sequential", "joint", "sqrt")

#: default backward segment length of the batch-layout adjoint: any
#: value gives identical gradients; it trades boundary-carry memory
#: against replay residual memory
DEFAULT_SEG = 128


def resolve_grad_engine(grad: Optional[str], engine: str,
                        dtype=None) -> str:
    """Resolve a gradient-engine request to ``"adjoint"``/``"autodiff"``.

    ``grad`` is an explicit mode or ``None`` for the configured default
    (:func:`metran_tpu_torch.config.grad_engine`, env
    ``METRAN_TPU_GRAD_ENGINE``; unknown values raise).  ``"auto"`` picks
    the closed-form adjoint for the sequential-scan engines and autodiff
    for everything else, except a float32 (``dtype``, a torch dtype)
    square-root deviance, which
    keeps autodiff (its QR backward avoids the covariance-form roundoff
    near ``phi -> 1``).  An explicit ``"adjoint"`` with an uncovered
    engine raises.
    """
    mode = _grad_engine(grad)
    if mode == "auto":
        if engine not in ADJOINT_ENGINES:
            return "autodiff"
        if engine == "sqrt" and dtype == torch.float32:
            return "autodiff"
        return "adjoint"
    if mode == "adjoint" and engine not in ADJOINT_ENGINES:
        raise ValueError(
            f"grad='adjoint' requires an engine in {ADJOINT_ENGINES}; "
            f"got {engine!r} — use grad='auto' (falls back to autodiff "
            "for the associative-scan engines) or grad='autodiff'"
        )
    return mode


__all__ = ["ADJOINT_ENGINES", "DEFAULT_SEG", "resolve_grad_engine"]
