"""Training substrate: optimizer, train step, data pipeline, checkpoints
(the port of the reference ``repro/training``)."""

from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        cosine_schedule, global_norm)
from .train_step import (TrainState, cross_entropy, init_train_state,
                         make_loss_fn, make_train_step)
from .data import DataConfig, SyntheticLM
from . import checkpoint
