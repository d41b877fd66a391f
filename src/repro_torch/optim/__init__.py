"""AdamW, learning-rate schedules and 1-bit gradient compression: the port
of ``repro.optim``."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .grad_compress import (compress_decompress, compressed_psum, compressed_wire_bytes,
                            ef_state_init)
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compress_decompress",
    "compressed_psum",
    "compressed_wire_bytes",
    "cosine_schedule",
    "ef_state_init",
    "wsd_schedule",
]
