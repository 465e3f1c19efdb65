from .ckpt import CheckpointManager, latest_step, load_checkpoint, save_checkpoint  # noqa: F401
