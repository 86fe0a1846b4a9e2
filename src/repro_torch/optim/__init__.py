"""Optimiser of the training path (the port of ``repro.optim``): AdamW
with global-norm clipping, the cosine schedule and int8 gradient
compression with error feedback."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import (CompressionState, compress_init,
                                           compressed_gradients)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "CompressionState", "compress_init",
    "compressed_gradients",
]
