"""Training substrate (mirrors ``repro.train``): optimizer, train step,
checkpointing, elasticity."""

from repro_torch.train.optim import (OptConfig, adamw_init, adamw_update,
                                     cosine_schedule)
from repro_torch.train.train_step import make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "make_train_step"]
