"""The port's model zoo: Llama-2 for serving, and generation."""

from paddle_tpu_torch.models.generation import (filter_logits, generate,
                                                sample_logits)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "filter_logits", "generate",
           "sample_logits"]
