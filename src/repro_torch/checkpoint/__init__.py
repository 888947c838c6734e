"""LOPC-compressed, fault-tolerant checkpoints of tensor pytrees (port
of ``repro.checkpoint``)."""
from .manager import CheckpointManager, available_steps, restore_tree, save_tree

__all__ = ["CheckpointManager", "available_steps", "save_tree", "restore_tree"]
