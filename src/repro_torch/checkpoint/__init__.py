from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore, save)

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]
