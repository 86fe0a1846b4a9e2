"""Checkpoints of the PyTorch port, in the JAX package's on-disk format
(``repro_torch.checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import (CheckpointCorrupt, CheckpointManager,
                                         all_steps, latest_step, load,
                                         load_latest_valid, peek_extra,
                                         restore, save, verify)

__all__ = ["CheckpointCorrupt", "CheckpointManager", "save", "restore",
           "load", "load_latest_valid", "latest_step", "all_steps",
           "peek_extra", "verify"]
