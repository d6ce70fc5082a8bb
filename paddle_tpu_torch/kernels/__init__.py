"""The port's hand-written Hopper kernels, one module each, with the plain
PyTorch version of each beside it: ``norm`` (RMSNorm and LayerNorm,
forward and backward), ``rope.apply_rotary``, ``flash_attention`` (forward and the dq
and dk/dv backward), ``decode_attention.decode_attention`` (float and
int8 caches, one index for the batch or one a slot),
``paged_decode_attention`` (one token a slot over the paged pool),
``adamw.adamw_update``, ``linear_xent`` (the fused LM head
⊗ cross-entropy forward, dH and dW), ``softmax_xent`` (softmax
cross-entropy's log-sum-exp and its backward) and ``selective_scan``
(Mamba's recurrence, forward and backward). The differentiable ones are
``torch.autograd.Function``s whose backward is a kernel too. See
``_support`` for the build, the dispatch rule, the launch counters and
``force_reference()``."""

from paddle_tpu_torch.kernels import (_support, adamw, decode_attention,
                                      flash_attention, linear_xent, norm,
                                      paged_decode_attention, rope,
                                      selective_scan, softmax_xent)

__all__ = ["_support", "adamw", "decode_attention", "flash_attention",
           "linear_xent", "norm", "paged_decode_attention", "rope",
           "selective_scan", "softmax_xent"]
