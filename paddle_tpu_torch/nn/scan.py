"""Per-block recompute over a stack of blocks — the port of the recompute
half of ``paddle_tpu/nn/scan.py`` (``REMAT_POLICIES`` :29-70 and
``ScannedBlocks.__call__`` :159-187).

The JAX package scans one stacked block under ``jax.checkpoint`` with a
policy; the port loops over an ``nn.ModuleList`` and wraps each block in
``torch.utils.checkpoint`` (non-reentrant), which keeps the block's inputs
and recomputes its forward, kernels included, during backward. A policy
that saves tensors becomes selective checkpointing: ``context_fn`` with
``create_selective_checkpoint_contexts``, whose policy marks the saved
aten ops MUST_SAVE (backward takes them from the forward instead of
running them again) and everything else PREFER_RECOMPUTE.

Policies (the JAX package's names):
- ``"none"``, ``"nothing_saveable"``: save nothing. ``"none"`` is
  ``jax.checkpoint`` without a policy, which saves nothing either, so with
  ``remat`` on both recompute everything; ``remat=False`` is how both
  packages turn recompute off;
- ``"dots_saveable"``: every matrix product's output
  (``checkpoint_dots``); ``"dots_with_no_batch_dims"``: every product
  without a batch dimension (``mm``, not ``bmm``);
- the named ones (``save_only_these_names``): the products made under a
  ``tag`` the policy names. The blocks put ``tag`` around the projection
  that makes each named tensor, where the JAX blocks call
  ``checkpoint_name`` on its value.

The kernels are ``ctypes`` launches inside ``autograd.Function``s, which
the policy never sees: their forwards run again in recompute whatever the
policy, and only the aten ops around them are saved or recomputed. So
under ``save_mlp_dots_attn`` the flash forward still runs twice a step:
the ``wo`` projection's output is saved, but its weight gradient needs
its input, the attention output, which is recomputed.

Dropout under recompute: ``torch.utils.checkpoint`` restores torch's
global RNG states for the recompute, not a caller's ``torch.Generator``,
so a recomputed block would draw other dropout masks than its forward
did and its gradients would be wrong. The JAX package replays each
layer's key (``paddle_tpu/nn/scan.py:159-187``); ``run_blocks`` replays
each block's generator state: it notes the state before the block's
forward, sets it again before the recompute, and puts the generator back
where the caller's stream had reached afterwards.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["REMAT_POLICIES", "SAVED_NAMES", "check_remat_policy", "tag",
           "run_blocks"]

# policy -> the tags whose products it saves
SAVED_NAMES = {
    "save_attn_out": ("attn_out",),
    "save_mlp_dots": ("mlp_gate", "mlp_up"),
    "save_mlp_dots_attn": ("mlp_gate", "mlp_up", "attn_out"),
    "save_mlp_up_attn": ("mlp_up", "attn_out"),
    "save_block_dots": ("mlp_gate", "mlp_up", "mlp_out", "attn_out"),
    "save_block_dots_qkv": ("mlp_gate", "mlp_up", "mlp_out", "attn_out",
                            "qkv"),
}
REMAT_POLICIES = ("none", "nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims", *SAVED_NAMES)

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}
_current_tag: str | None = None


def check_remat_policy(policy: str) -> None:
    """Raise unless ``policy`` is one of ``REMAT_POLICIES``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")


@contextlib.contextmanager
def tag(name: str):
    """The products made inside carry the tag ``name`` for the named
    policies (``jax.ad_checkpoint.checkpoint_name``). Costs nothing
    outside a checkpointed block."""
    global _current_tag
    prev, _current_tag = _current_tag, name
    try:
        yield
    finally:
        _current_tag = prev


def _saves(policy: str, op) -> bool:
    if policy == "dots_saveable":
        return op in _DOTS
    if policy == "dots_with_no_batch_dims":
        return op in _NO_BATCH_DOTS
    return op in _DOTS and _current_tag in SAVED_NAMES[policy]


@functools.cache
def _context_fn(policy: str):
    """``checkpoint``'s ``context_fn`` for a policy that saves tensors,
    None for one that saves nothing."""
    if policy in ("none", "nothing_saveable"):
        return None

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if _saves(policy, op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _replaying(block, generator: torch.Generator):
    """``block`` wrapped so that every call starts from ``generator``'s
    present state: the recompute draws the forward's dropout masks. The
    first call leaves the generator advanced, as a plain forward would;
    a later call (the recompute, during backward) restores the state it
    found."""
    start = generator.get_state()
    calls = [0]

    def run(*args, **kwargs):
        found = generator.get_state()
        generator.set_state(start)
        try:
            return block(*args, **kwargs)
        finally:
            if calls[0]:
                generator.set_state(found)
            calls[0] += 1
    return run


def run_blocks(blocks, x, *args, remat: bool = False,
               policy: str = "nothing_saveable",
               generator: torch.Generator | None = None, **kwargs):
    """``x`` through each block in order, ``block(x, *args, **kwargs)``
    (plus ``generator=generator`` when one is given). With ``remat`` and
    gradients enabled, each block keeps its inputs and what ``policy``
    saves, and recomputes the rest of its forward in backward, replaying
    its draws from ``generator``."""
    if generator is not None:
        kwargs["generator"] = generator
    if remat and torch.is_grad_enabled():
        check_remat_policy(policy)
        context_fn = _context_fn(policy)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        for block in blocks:
            fn = block if generator is None else _replaying(block, generator)
            x = checkpoint(fn, x, *args, use_reentrant=False, **kw,
                           **kwargs)
        return x
    for block in blocks:
        x = block(x, *args, **kwargs)
    return x
