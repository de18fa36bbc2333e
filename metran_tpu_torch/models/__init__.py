"""Model-level API: the Metran orchestrator, factor analysis, solvers
and the batched L-BFGS they share (:mod:`.lbfgs`)."""

from .factoranalysis import FactorAnalysis
from .metran import Metran
from .solver import (
    BaseSolver,
    JaxSolve,
    LanesSolve,
    LmfitSolve,
    ScipySolve,
)

__all__ = [
    "BaseSolver",
    "FactorAnalysis",
    "JaxSolve",
    "LanesSolve",
    "LmfitSolve",
    "Metran",
    "ScipySolve",
]
