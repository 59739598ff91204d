from .trainer import (TrainState, make_compressed_train_step, make_grad_fn,
                      make_kd_grad_fn, make_kd_train_step, make_train_step,
                      observe_train_sparsity, train_state_init)
from .checkpoint import (AsyncCheckpointer, latest_checkpoint,
                         restore_checkpoint, save_checkpoint)
from .elastic import ElasticRunner
from .straggler import StragglerMonitor

__all__ = ["TrainState", "make_compressed_train_step", "make_grad_fn",
           "make_kd_grad_fn", "make_kd_train_step", "make_train_step",
           "observe_train_sparsity", "train_state_init", "AsyncCheckpointer",
           "latest_checkpoint", "restore_checkpoint", "save_checkpoint",
           "ElasticRunner", "StragglerMonitor"]
