"""The port's model zoo: Llama-2, GPT-3 and ERNIE for serving and
training, and generation."""

from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieForPretraining,
                                           ErnieModel)
from paddle_tpu_torch.models.generation import (filter_logits, generate,
                                                sample_logits)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["ErnieConfig", "ErnieForPretraining", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "filter_logits", "generate", "sample_logits"]
