from .manager import CheckpointManager, restore_checkpoint, save_checkpoint  # noqa: F401
