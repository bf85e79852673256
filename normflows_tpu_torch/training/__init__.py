from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .loop import (TrainState, cosine_decay_schedule, make_chunked_train_step, make_step_chunk,
                   make_train_step, warmup_cosine_decay_schedule)

__all__ = ["CheckpointManager", "TrainState", "cosine_decay_schedule",
           "make_chunked_train_step", "make_step_chunk", "make_train_step",
           "restore_checkpoint", "save_checkpoint", "warmup_cosine_decay_schedule"]
