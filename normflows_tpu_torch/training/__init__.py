from .loop import TrainState, make_chunked_train_step, make_train_step

__all__ = ["TrainState", "make_chunked_train_step", "make_train_step"]
