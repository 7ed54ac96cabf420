"""Model stack (mirror of ``pctrans_tpu.models``), recipe path."""

from .pctrans import PCTransModel

__all__ = ["PCTransModel"]
