"""Per-block recompute over a stack of blocks — the port of the recompute
half of ``paddle_tpu/nn/scan.py`` (``REMAT_POLICIES`` :29-70 and
``ScannedBlocks.__call__`` :159-187).

The JAX package scans one stacked block under ``jax.checkpoint`` with a
policy; the port loops over an ``nn.ModuleList`` and wraps each block in
``torch.utils.checkpoint`` (non-reentrant), which keeps only the block's
inputs and recomputes its forward, kernels included, during backward.

Policies:
- ``"nothing_saveable"``: recompute everything (the default);
- ``"none"``: the JAX package maps it to ``policy=None``, and
  ``jax.checkpoint`` without a policy saves nothing either, so with
  ``remat`` on it recomputes everything too. ``remat=False`` is how both
  packages turn recompute off;
- the policies that save named tensors (matmul outputs, the attention
  output, the q/k/v projections) raise ``NotImplementedError``: they need
  the blocks to tag those tensors, which the port's blocks do not yet.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["REMAT_POLICIES", "NAMED_POLICIES", "check_remat_policy",
           "run_blocks"]

REMAT_POLICIES = ("none", "nothing_saveable")
NAMED_POLICIES = ("dots_saveable", "dots_with_no_batch_dims",
                  "save_attn_out", "save_mlp_dots", "save_mlp_dots_attn",
                  "save_mlp_up_attn", "save_block_dots",
                  "save_block_dots_qkv")


def check_remat_policy(policy: str) -> None:
    """Raise unless the port runs ``policy``."""
    if policy in REMAT_POLICIES:
        return
    if policy in NAMED_POLICIES:
        raise NotImplementedError(
            f"remat policy {policy!r} saves named tensors, which the port's "
            f"blocks do not tag yet; use one of {REMAT_POLICIES} or "
            "remat=False")
    raise ValueError(f"unknown remat policy {policy!r}; one of "
                     f"{REMAT_POLICIES + NAMED_POLICIES}")


def run_blocks(blocks, x, *args, remat: bool = False,
               policy: str = "nothing_saveable"):
    """``x`` through each block in order, ``block(x, *args)``. With
    ``remat`` and gradients enabled, each block keeps only its inputs and
    recomputes its forward in backward."""
    if remat and torch.is_grad_enabled():
        check_remat_policy(policy)
        for block in blocks:
            x = checkpoint(block, x, *args, use_reentrant=False)
        return x
    for block in blocks:
        x = block(x, *args)
    return x
