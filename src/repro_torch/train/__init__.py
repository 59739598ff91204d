from .trainer import (TrainState, make_grad_fn, make_kd_grad_fn,
                      make_kd_train_step, make_train_step,
                      observe_train_sparsity, train_state_init)

__all__ = ["TrainState", "make_grad_fn", "make_kd_grad_fn",
           "make_kd_train_step", "make_train_step", "observe_train_sparsity",
           "train_state_init"]
