"""The port's ``fleet``: the single-device training step."""

from paddle_tpu_torch.distributed.fleet.strategy_compiler import (
    TrainState, TrainStep, build_train_step)

__all__ = ["TrainState", "TrainStep", "build_train_step"]
