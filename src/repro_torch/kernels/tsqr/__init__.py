from .fused import countsketch_gram, sketch_qr
from .ops import MAX_FUSED_COLS, cholqr_finish, panel_gram, tsqr
from .ref import countsketch_gram_ref, panel_gram_ref, tsqr_ref

__all__ = [
    "MAX_FUSED_COLS",
    "cholqr_finish",
    "countsketch_gram",
    "countsketch_gram_ref",
    "panel_gram",
    "panel_gram_ref",
    "sketch_qr",
    "tsqr",
    "tsqr_ref",
]
