"""Small host-side utilities (logging, validation, versions).

Port of ``metran_tpu/utils/__init__.py`` (a copy: the port imports
nothing of the JAX package), without its profiling helpers.  Local
equivalents of the pastas helpers the reference imports
(``pastas.utils.validate_name`` / ``frequency_is_supported``,
``pastas.plotting.plotutil._get_height_ratios``).  pandas is imported
where it is used, so the package imports without it.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple


def initialize_logger(logger=None, level=logging.INFO) -> None:
    """Attach a stream handler to the metran_tpu_torch logger hierarchy
    once."""
    if logger is None:
        logger = logging.getLogger("metran_tpu_torch")
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        logger.addHandler(handler)


ILLEGAL_NAME_CHARS = ["/", "\\", " "]


def validate_name(name: str, raise_error: bool = False) -> str:
    """Check a model/series name for characters that break file storage."""
    name = str(name)
    for char in ILLEGAL_NAME_CHARS:
        if char in name:
            msg = f"Name '{name}' contains illegal character '{char}'."
            if raise_error:
                raise ValueError(msg)
            logging.getLogger("metran_tpu_torch").warning(msg)
    return name


def frequency_is_supported(freq: str) -> str:
    """Validate a pandas frequency string and return it.

    Only fixed-length frequencies (multiples of D/h/min/s/ms/us/ns) are
    meaningful for the AR(1) decay parameterization; anything
    ``to_offset`` rejects or that has no fixed length raises ValueError.
    """
    from pandas.tseries.frequencies import to_offset

    try:
        offset = to_offset(freq)
        offset.nanos  # only Tick-like offsets have a fixed length
    except Exception as e:
        raise ValueError(f"Frequency {freq!r} is not supported: {e}") from e
    return freq


def freq_to_days(freq: str) -> float:
    """Length of one frequency step in days (the AR(1) ``dt``)."""
    from pandas import Timedelta
    from pandas.tseries.frequencies import to_offset

    return to_offset(freq).nanos / Timedelta(1, "D").value


def get_height_ratios(ylims: Sequence[Tuple[float, float]]) -> List[float]:
    """Relative subplot heights proportional to each panel's y-range."""
    spans = [abs(y1 - y0) for (y0, y1) in ylims]
    total = sum(spans)
    if total == 0:
        return [1.0] * len(ylims)
    return [max(s / total, 0.05) for s in spans]


def show_versions() -> None:
    """Print versions of the numerical stack and the CUDA card."""
    from sys import version as py_version

    import numpy
    import scipy
    import torch

    from .. import __version__

    try:
        import pandas

        pandas_version = pandas.__version__
    except ModuleNotFoundError:
        pandas_version = "not installed"
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "none")
    print(
        f"metran_tpu_torch version: {__version__}\n"
        f"Python version: {py_version}\n"
        f"numpy version: {numpy.__version__}\n"
        f"scipy version: {scipy.__version__}\n"
        f"pandas version: {pandas_version}\n"
        f"torch version: {torch.__version__}\n"
        f"CUDA version: {torch.version.cuda}\n"
        f"CUDA device: {card}"
    )


__all__ = [
    "ILLEGAL_NAME_CHARS",
    "freq_to_days",
    "frequency_is_supported",
    "get_height_ratios",
    "initialize_logger",
    "show_versions",
    "validate_name",
]
