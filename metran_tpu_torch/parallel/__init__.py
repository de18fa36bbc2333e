"""Fleet helpers (only the padding rule is ported yet)."""

from .mesh import pad_to_multiple

__all__ = ["pad_to_multiple"]
