"""The training step: loss, gradients and the AdamW update."""

from repro_torch.training.train_step import (TrainState, cross_entropy,  # noqa: F401
                                             make_loss_fn, make_prefill_step, make_train_step)
