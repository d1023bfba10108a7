"""The port's copy of the annotation vocabulary of ``repro.analysis``.

Only :mod:`~repro_torch.analysis.annotations` is ported: the reference's
lint checker (``python -m repro.analysis``) reads the port's sources as
text and needs nothing at run time.
"""
from .annotations import GUARDED_BY_ATTR, guarded_by

__all__ = ["GUARDED_BY_ATTR", "guarded_by"]
