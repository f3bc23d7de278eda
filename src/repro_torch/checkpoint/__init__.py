"""Checkpoints of training trees (see ckpt.py)."""
from .ckpt import (latest_step, restore_checkpoint, restore_repro_checkpoint,  # noqa: F401
                   save_checkpoint, wait_pending)
