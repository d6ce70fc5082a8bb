"""The port's model zoo: Llama-2, GPT-3, ERNIE and Mamba for serving and
training, and generation."""

from paddle_tpu_torch.models.ernie import (ErnieConfig, ErnieForPretraining,
                                           ErnieModel)
from paddle_tpu_torch.models.generation import (filter_logits, generate,
                                                sample_logits)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.mamba import (MambaBlock, MambaConfig,
                                           MambaForCausalLM)

__all__ = ["ErnieConfig", "ErnieForPretraining", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "MambaBlock", "MambaConfig", "MambaForCausalLM",
           "filter_logits", "generate", "sample_logits"]
