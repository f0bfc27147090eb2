"""The port's train step (``repro.train``)."""
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_eval_step, make_train_step)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_eval_step"]
