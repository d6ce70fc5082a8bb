"""paddle_tpu_torch.distributed — so far the single-device training step
(``fleet.build_train_step``) and the strategy object it reads."""

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.strategy import DistributedStrategy

__all__ = ["fleet", "DistributedStrategy"]
