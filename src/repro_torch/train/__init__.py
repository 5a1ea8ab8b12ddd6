"""Training substrate: optimizers and the train step (``launch.train``
drives them under ``runtime.TrainSupervisor``)."""
from .optimizer import adafactor, adamw, cosine_schedule, make_optimizer, wsd_schedule
from .train_step import init_train_state, make_train_step

__all__ = ["adafactor", "adamw", "cosine_schedule", "make_optimizer", "wsd_schedule",
           "init_train_state", "make_train_step"]
