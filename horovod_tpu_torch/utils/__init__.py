"""Utilities: checkpoint/resume (``checkpoint.py``)."""

from .checkpoint import (checkpoint_path, latest_checkpoint,  # noqa: F401
                         restore_checkpoint, restore_checkpoint_sharded,
                         save_checkpoint, save_checkpoint_sharded)
