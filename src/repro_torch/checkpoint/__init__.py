"""Checkpointing (the reference's :mod:`repro.checkpoint`):
:mod:`.manager` writes atomic, keep-last-k, optionally asynchronous
checkpoints in the reference's on-disk layout; :mod:`.replicated` is the
diskless buddy store whose replica placement is the redundant plan's."""
from .manager import CheckpointManager, flatten_tree, unflatten_like
from .replicated import BuddyStore

__all__ = ["BuddyStore", "CheckpointManager", "flatten_tree", "unflatten_like"]
