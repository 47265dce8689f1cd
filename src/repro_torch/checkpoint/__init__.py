from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint)
