"""Mamba (selective state-space model) — the port of
``paddle_tpu/models/mamba.py`` for serving and training.

The selective recurrence runs through the port's scan kernels
(``kernels/selective_scan.py``, which replace the Pallas
``selective_scan.py``): the whole sequence in one launch per layer for
the forward (training and prefill, with the carried state) and one for
the backward. A decode step is the recurrence's single step in torch ops,
as in the JAX package (``mamba.py:268-282``), which has no kernel for it.

Layers are an ``nn.ModuleList`` of blocks (``bridge.py`` unstacks the JAX
package's scanned block); ``cfg.remat`` recomputes each block's forward
in backward, as ``ScannedBlocks(remat=True)`` does under its default
``nothing_saveable``. ``A_log`` and ``D`` stay fp32 in a bf16 model.
Weights are ``[in, out]`` as in the JAX package; the model is built on
its device in its dtype from the caller's generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.device import dtype_of, make_generator, resolve_device
from paddle_tpu_torch.kernels import selective_scan as _scan
from paddle_tpu_torch.models._common import causal_lm_loss
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common import Embedding, Linear
from paddle_tpu_torch.nn.norm import RMSNorm
from paddle_tpu_torch.nn.scan import run_blocks

__all__ = ["MambaConfig", "MambaBlock", "MambaForCausalLM",
           "selective_scan"]


@dataclass(frozen=True)
class MambaConfig:
    vocab_size: int = 50277
    hidden_size: int = 768
    num_layers: int = 24
    state_size: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int | None = None        # defaults to ceil(hidden/16)
    dtype: str = "float32"
    remat: bool = False
    # the JAX spec's chunk length; the port's kernels choose their own
    # (the result does not depend on it beyond rounding)
    scan_chunk_size: int | None = 128
    # LM-head loss path (tied: the head weight is embed.weight.T)
    lm_head_mode: str = "dense"

    @property
    def inner_size(self) -> int:
        return self.expand * self.hidden_size

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.hidden_size // 16)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    state_size=8, dtype="float32")
        base.update(kw)
        return cls(**base)

    def num_params(self) -> int:
        """Exact parameter count (embeddings are tied — counted once)."""
        E, Ei, N, R = (self.hidden_size, self.inner_size,
                       self.state_size, self.rank)
        per_layer = (E * 2 * Ei                     # in_proj
                     + Ei * self.conv_kernel + Ei   # conv w + b
                     + Ei * (R + 2 * N)             # x_proj
                     + R * Ei + Ei                  # dt_proj w + b
                     + Ei * N + Ei                  # A_log + D
                     + Ei * E                       # out_proj
                     + E)                           # norm
        return self.vocab_size * E + self.num_layers * per_layer + E


def selective_scan(u, delta, A, B, C, D, chunk_size: int | None = None,
                   return_state: bool = False, initial_state=None):
    """y = SSM(u) (``paddle_tpu/models/mamba.py:79``): u, delta [B, T, Ei],
    A [Ei, N], B, C [B, T, N], D [Ei]; ``initial_state`` seeds h_0 and
    ``return_state`` also returns h_T [B, Ei, N]. The scan kernel on CUDA
    tensors (fp32), its plain version on CPU tensors. ``chunk_size`` is
    the JAX spec's memory knob and changes nothing here."""
    return _scan.selective_scan(u, delta, A, B, C, D,
                                initial_state=initial_state,
                                return_state=return_state)


def _xavier_std(fan_in: int, fan_out: int) -> float:
    """The JAX ``Linear``'s XavierUniform variance, as a normal's std."""
    return math.sqrt(2.0 / (fan_in + fan_out))


class MambaBlock(nn.Module):
    def __init__(self, cfg: MambaConfig, *, device, dtype, generator):
        super().__init__()
        E, Ei, N, R = (cfg.hidden_size, cfg.inner_size, cfg.state_size,
                       cfg.rank)
        K = cfg.conv_kernel

        def linear(i, o, bias=False):
            return Linear(i, o, bias=bias, std=_xavier_std(i, o),
                          device=device, dtype=dtype, generator=generator)

        self.in_proj = linear(E, 2 * Ei)
        # depthwise causal conv weights [Ei, K], U(-1, 1) / sqrt(K)
        w = torch.empty((Ei, K), device=device, dtype=torch.float32)
        w.uniform_(-1.0, 1.0, generator=generator)
        self.conv_weight = nn.Parameter((w / math.sqrt(K)).to(dtype))
        self.conv_bias = nn.Parameter(torch.zeros((Ei,), device=device,
                                                  dtype=dtype))
        self.x_proj = linear(Ei, R + 2 * N)
        self.dt_proj = linear(R, Ei, bias=True)
        # S4D-real init: A = -exp(A_log) = -(1..N), fp32 in any model type
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=device)).expand(
            Ei, N).clone())
        self.D = nn.Parameter(torch.ones((Ei,), device=device,
                                         dtype=torch.float32))
        self.out_proj = linear(Ei, E)
        self.norm = RMSNorm(E, device=device, dtype=dtype)
        self.state_size = N
        self.rank = R
        self.conv_kernel = K

    def _in_split(self, x):
        """norm + in_proj → (u_raw, z): the conv input and the gate."""
        return self.in_proj(self.norm(x)).chunk(2, dim=-1)

    def _ssm_coeffs(self, u):
        """u (post-conv activations, any leading dims) → (delta, B, C, A)
        in fp32."""
        dt, Bc, Cc = torch.split(self.x_proj(u), [
            self.rank, self.state_size, self.state_size], dim=-1)
        delta = F.softplus(self.dt_proj(dt))
        A = -torch.exp(self.A_log)                            # [Ei, N]
        return delta.float(), Bc.float(), Cc.float(), A

    def _conv_seq(self, u_raw, left_ctx=None):
        """Causal depthwise conv over time of [B, T, Ei]: the sum over the
        K windows of the padded input (``left_ctx`` [B, K-1, Ei], the
        carried tail, or K-1 zeros at a sequence start) times their
        weights, in fp32, then silu(· + bias). Returns ``(u, ctx)``; the
        last K-1 steps of ctx are the next carried tail."""
        K, T = self.conv_kernel, u_raw.shape[1]
        if left_ctx is None:
            ctx = torch.nn.functional.pad(u_raw, (0, 0, K - 1, 0))
        else:
            ctx = torch.cat([left_ctx.to(u_raw.dtype), u_raw], dim=1)
        w = self.conv_weight.float()
        u = ctx[:, 0:T].float() * w[:, 0]
        for i in range(1, K):
            u = u + ctx[:, i:i + T].float() * w[:, i]
        return F.silu(u.to(u_raw.dtype) + self.conv_bias), ctx

    def forward(self, x):
        residual = x
        u_raw, z = self._in_split(x)                          # [B, T, Ei]
        u, _ = self._conv_seq(u_raw)
        delta, Bc, Cc, A = self._ssm_coeffs(u)
        y = selective_scan(u.float(), delta, A, Bc, Cc, self.D)
        y = y.to(x.dtype) * F.silu(z)
        return residual + self.out_proj(y)

    # ---- stateful decode (the recurrent O(1)-per-token form) ----------

    def init_state(self, batch_size: int, dtype):
        """(conv tail [B, K-1, Ei] in ``dtype``, ssm state [B, Ei, N]
        fp32)."""
        Ei = self.conv_weight.shape[0]
        dev = self.conv_weight.device
        return (torch.zeros((batch_size, self.conv_kernel - 1, Ei),
                            dtype=dtype, device=dev),
                torch.zeros((batch_size, Ei, self.state_size),
                            dtype=torch.float32, device=dev))

    def prefill(self, x, state):
        """Sequence forward that consumes and returns the decode state:
        the carried conv tail replaces the causal zero padding, and the
        carried SSM state seeds the scan kernel, which returns the final
        one."""
        conv_tail, h0 = state
        residual = x
        u_raw, z = self._in_split(x)
        u, ctx = self._conv_seq(u_raw, left_ctx=conv_tail)
        delta, Bc, Cc, A = self._ssm_coeffs(u)
        y, h_last = selective_scan(u.float(), delta, A, Bc, Cc, self.D,
                                   return_state=True, initial_state=h0)
        y = y.to(x.dtype) * F.silu(z)
        # an explicit start: for K == 1 the tail is empty
        tail = ctx[:, ctx.shape[1] - (self.conv_kernel - 1):]
        return residual + self.out_proj(y), (tail, h_last)

    def step(self, x, state):
        """One decode step: x [B, E], state from init_state/prefill."""
        conv_tail, h = state
        residual = x
        u_raw, z = self._in_split(x)                          # [B, Ei]
        window = torch.cat([conv_tail, u_raw[:, None]], dim=1)
        u = (window.float() * self.conv_weight.float().T).sum(1)
        u = F.silu(u.to(x.dtype) + self.conv_bias)
        delta, Bc, Cc, A = self._ssm_coeffs(u)
        uf = u.float()
        dA = torch.exp(delta[..., None] * A)                  # [B, Ei, N]
        dBu = (delta * uf)[..., None] * Bc[:, None, :]
        h = dA * h + dBu
        y = torch.einsum("bin,bn->bi", h, Cc) + uf * self.D
        y = y.to(x.dtype) * F.silu(z)
        return residual + self.out_proj(y), (window[:, 1:], h)


class MambaForCausalLM(nn.Module):
    """Mamba LM with tied embeddings. ``model(ids)`` returns logits
    [B, T, V]. ``device=None`` builds on the current CUDA device and
    raises without one; ``dtype=None`` takes ``cfg.dtype``; weights are
    drawn from ``generator`` (else a generator on ``device`` seeded with
    0)."""

    def __init__(self, cfg: MambaConfig, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype_of(dtype or cfg.dtype)
        if generator is None:
            generator = make_generator(0, device)
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size, std=0.02,
                               generator=generator, **kw)
        self.blocks = nn.ModuleList(
            MambaBlock(cfg, generator=generator, **kw)
            for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, **kw)
        self.config = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    def hidden_states(self, input_ids, training: bool = False):
        """embed → blocks (each recomputed in backward under
        ``cfg.remat``) → final norm. Mamba has no dropout: ``training``
        is taken for the JAX package's signature
        (``paddle_tpu/models/mamba.py:298``) and changes nothing."""
        x = run_blocks(self.blocks, self.embed(input_ids),
                       remat=self.config.remat)
        return self.norm(x)

    def forward(self, input_ids, training: bool = False):
        return self.hidden_states(input_ids, training) @ self.embed.weight.T

    def loss(self, input_ids, labels, ignore_index: int = -100,
             training: bool = True,
             generator: torch.Generator | None = None):
        """Next-token cross entropy through ``cfg.lm_head_mode`` with the
        tied head ``embed.weight.T`` (``_common.causal_lm_loss``). Mamba
        has no dropout: ``training`` goes to the trunk as in the JAX
        package, and ``generator`` is taken for the training step's call
        and not used."""
        return causal_lm_loss(self, self.embed.weight.T, input_ids, labels,
                              ignore_index, training=training)

    # ---- decode interface (models/generation.py contract) -------------
    # The "cache" is the per-layer recurrent state (conv tail + SSM
    # state), O(1) in sequence length; ``max_len`` and ``index`` are taken
    # and ignored (the state is positionless).

    def init_cache(self, batch_size: int, max_len: int | None = None,
                   dtype=None):
        """``(conv tails [L, B, K-1, Ei], ssm states [L, B, Ei, N] fp32)``
        of zeros. ``dtype`` (default the model's) is the conv tails';
        ``torch.int8``, the attention families' quantized cache, maps back
        to the model's type (the recurrent state accumulates); other
        integer types raise."""
        cfg = self.config
        dtype = dtype_of(dtype or self.dtype)
        if dtype == torch.int8:
            dtype = self.dtype
        elif not dtype.is_floating_point:
            raise ValueError(f"cache dtype {dtype} unsupported: use a float "
                             "dtype (or torch.int8, which Mamba maps back "
                             "to its float state)")
        L, Ei = cfg.num_layers, cfg.inner_size
        return (torch.zeros((L, batch_size, cfg.conv_kernel - 1, Ei),
                            dtype=dtype, device=self.device),
                torch.zeros((L, batch_size, Ei, cfg.state_size),
                            dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def forward_with_cache(self, input_ids, cache, index: int = 0):
        """Returns (logits [B, T, V], new cache). T > 1: prefill, each
        layer's scan kernel seeded with and returning its state (so a
        prefill continues from a warm cache exactly); T == 1: one
        recurrent step. ``index`` is ignored."""
        x = self.embed(input_ids)
        one = input_ids.shape[1] == 1
        h = x[:, 0] if one else x
        tails, states = [], []
        for i, block in enumerate(self.blocks):
            state = (cache[0][i], cache[1][i])
            h, (tail, ssm) = (block.step(h, state) if one
                              else block.prefill(h, state))
            tails.append(tail)
            states.append(ssm)
        if one:
            h = h[:, None]
        logits = self.norm(h) @ self.embed.weight.T
        return logits, (torch.stack(tails), torch.stack(states))

    def generate(self, input_ids, max_new_tokens: int, **kwargs):
        """Autoregressive decode — see ``paddle_tpu_torch.models.
        generation``."""
        from paddle_tpu_torch.models.generation import generate
        return generate(self, input_ids, max_new_tokens, **kwargs)
