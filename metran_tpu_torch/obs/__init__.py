"""Observability: the per-fit optimizer telemetry
(:class:`~metran_tpu_torch.obs.telemetry.FitTelemetry`)."""

from .telemetry import FitTelemetry

__all__ = ["FitTelemetry"]
