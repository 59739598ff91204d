from .adamw import AdamWState, adamw_init, adamw_update
from .clip import clip_by_global_norm, global_norm
from .compression import (compress_int8, compressed_psum_grads,
                          decompress_int8, error_feedback_init)
from .schedules import constant_lr, cosine_lr, linear_warmup_cosine
from .sgd import SGDState, sgd_init, sgd_update

__all__ = ["AdamWState", "adamw_init", "adamw_update", "SGDState",
           "sgd_init", "sgd_update", "constant_lr", "cosine_lr",
           "linear_warmup_cosine", "global_norm", "clip_by_global_norm",
           "compress_int8", "decompress_int8", "compressed_psum_grads",
           "error_feedback_init"]
