from .adamw import AdamWState, adamw_init, adamw_update
from .schedules import constant_lr, cosine_lr, linear_warmup_cosine
from .sgd import SGDState, sgd_init, sgd_update

__all__ = ["AdamWState", "adamw_init", "adamw_update", "SGDState",
           "sgd_init", "sgd_update", "constant_lr", "cosine_lr",
           "linear_warmup_cosine"]
