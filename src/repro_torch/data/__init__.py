"""The port's synthetic data pipeline (``repro.data``)."""
from .synthetic import SyntheticConfig, batch_at, make_batch_specs

__all__ = ["SyntheticConfig", "batch_at", "make_batch_specs"]
