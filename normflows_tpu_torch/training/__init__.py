from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .loop import (TrainState, cosine_decay_schedule, make_chunked_train_step, make_step_chunk,
                   make_train_step)

__all__ = ["CheckpointManager", "TrainState", "cosine_decay_schedule",
           "make_chunked_train_step", "make_step_chunk", "make_train_step",
           "restore_checkpoint", "save_checkpoint"]
