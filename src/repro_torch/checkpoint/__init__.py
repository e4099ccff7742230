"""``repro_torch.checkpoint`` — tensor checkpoints in the JAX package's file
layout, and the manager that pairs them with the scalar ledger."""
from repro_torch.checkpoint.io import load_meta, load_tree, save_tree
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "load_meta", "load_tree", "save_tree"]
