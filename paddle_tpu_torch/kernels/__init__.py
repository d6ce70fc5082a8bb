"""The port's hand-written Hopper kernels, one module each, with the plain
PyTorch version of each beside it: ``norm.rms_norm``,
``rope.apply_rotary``, ``flash_attention.flash_attention`` and
``decode_attention.decode_attention``. See ``_support`` for the build,
the dispatch rule, the launch counters and ``force_reference()``."""

from paddle_tpu_torch.kernels import (_support, decode_attention,
                                      flash_attention, norm, rope)

__all__ = ["_support", "decode_attention", "flash_attention", "norm", "rope"]
