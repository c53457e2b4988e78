"""Attention modules: self/cross attention, FFT attention, the transformer
blocks over spatial tokens, and the OpenAI qkv attention block.

Port of the JAX package's ``models/attention.py``. Every dot-product
attention goes through ``ops.scaled_attention`` (the CUDA kernel on a card,
its plain version on the CPU), in the [B, N, heads, D] layout, so q, k and v
are the projections' outputs viewed as heads with no copy:

- ``CrossAttention``: bias-free ``to_q``/``to_k``/``to_v``, ``to_out`` with
  bias; self-attention without a context, cross-attention (M keys from the
  context, M != N) with one.
- ``FFTAttention``: the similarity ``irfft(rfft(q) . rfft(k), n=M)`` over
  the key axis (FFTs in f32), softmax, then ``@ v`` in v's dtype. It has no
  kernel: ``torch.fft`` computes it, as XLA does in the JAX package.
- ``FeedForward`` (GEGLU or plain, tanh GELU), ``BasicTransformerBlock``
  (pre-LayerNorm, eps 1e-6: attn1, attn2, ff) and ``SpatialTransformer``
  (GroupNorm, ``proj_in``, the blocks, zero-init ``proj_out``, residual)
  over an NCHW map flattened to tokens in the JAX package's [B, H*W, C]
  order.
- ``AttentionBlock``: GroupNorm, fused qkv, heads, attention, zero-init
  projection, residual.

A Flax ``Dense`` infers its input width; here ``context_dim`` names the
context's width (None: the query's width, as for self-attention). Dropout
draws its masks from the generator ``layers.dropout_generator`` binds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scaled_attention
from .layers import Dense, GroupNorm32, zero_init

__all__ = [
    "LayerNorm",
    "CrossAttention",
    "FFTAttention",
    "FeedForward",
    "BasicTransformerBlock",
    "SpatialTransformer",
    "AttentionBlock",
]


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics and affine whatever the input dtype,
    eps 1e-6 (Flax's default), cast back to the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: in training, each element kept with
    probability ``1 - rate`` and scaled by its inverse; the mask drawn from
    the generator ``dropout_generator`` binds."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.rate > 0):
            return x
        if self.generator is None:
            raise RuntimeError("attention dropout needs a generator bound by "
                               "dropout_generator")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class CrossAttention(nn.Module):
    """Multi-head self- or cross-attention: ``context=None`` attends over
    ``x`` itself, else over the context's M tokens."""

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)
        self.drop = Dropout(dropout)

    def _qkv(self, x, context):
        ctx = x if context is None else context
        B, N, M = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(B, N, self.heads, self.dim_head)
        k = self.to_k(ctx).view(B, M, self.heads, self.dim_head)
        v = self.to_v(ctx).view(B, M, self.heads, self.dim_head)
        return q, k, v

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, N, query_dim], context [B, M, context_dim] or None."""
        q, k, v = self._qkv(x, context)
        B, N = x.shape[:2]
        out = scaled_attention(q, k, v).reshape(B, N, -1)
        return self.drop(self.to_out(out))


class FFTAttention(CrossAttention):
    """Frequency-domain similarity attention: sim = irfft(rfft(q) .
    rfft(k), n=M) over the key axis, each FFT in f32, times dim_head**-0.5;
    softmax; @ v in v's dtype. The same parameters as ``CrossAttention``."""

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = (t.transpose(1, 2) for t in self._qkv(x, context))
        B, N, M = x.shape[0], q.shape[2], k.shape[2]
        qf = torch.fft.rfft(q.float(), dim=-1)
        kf = torch.fft.rfft(k.float(), dim=-1)
        sim = torch.einsum("bhid,bhjd->bhij", qf, kf) * self.dim_head**-0.5
        # irfft over the key axis: its first M // 2 + 1 entries, as numpy
        sim = torch.fft.irfft(sim, n=M, dim=-1)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(B, N, -1)
        return self.drop(self.to_out(out))


class FeedForward(nn.Module):
    """GEGLU (``glu``: ``proj_in`` to twice the inner width, value times
    GELU of the gate) or GELU feed-forward; GELU's tanh form, Flax's
    default."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 glu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        self.glu = glu
        self.proj_in = Dense(dim, 2 * inner if glu else inner, dtype=dtype)
        self.drop = Dropout(dropout)
        self.proj_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(x)
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate, approximate="tanh")
        else:
            h = F.gelu(h, approximate="tanh")
        return self.proj_out(self.drop(h))


class BasicTransformerBlock(nn.Module):
    """Pre-LN block: x + attn1(norm1 x), x + attn2(norm2 x, context),
    x + ff(norm3 x). ``use_fft`` takes ``FFTAttention`` for both;
    ``disable_self_attn`` gives attn1 the context too."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, use_fft: bool = False,
                 disable_self_attn: bool = False,
                 context_dim: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        Attn = FFTAttention if use_fft else CrossAttention
        self.disable_self_attn = disable_self_attn
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attn(dim, context_dim if disable_self_attn else None,
                          heads, dim_head, dropout, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attn(dim, context_dim, heads, dim_head, dropout, dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x),
                           context if self.disable_self_attn else None)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer over the tokens of an NCHW map: GroupNorm -> ``proj_in``
    (a Dense: a 1x1 conv, so ``use_linear`` changes nothing) -> ``depth``
    blocks ``block_{i}`` -> zero-init ``proj_out`` -> residual. Tokens are
    the map's positions in row-major (h, w) order, the JAX package's
    [B, H*W, C]. ``use_fft`` gives SpatialTransformer_fft."""

    def __init__(self, in_channels: int, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0,
                 use_linear: bool = False, use_fft: bool = False,
                 disable_self_attn: bool = False,
                 context_dim: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(in_channels)
        self.proj_in = Dense(in_channels, inner, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, dropout, use_fft, disable_self_attn,
                context_dim, dtype))
        self.depth = depth
        self.proj_out = zero_init(Dense(inner, in_channels, dtype=dtype))

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, C, H, W], context [B, M, context_dim] or None."""
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        h = self.proj_out(h)
        return x + h.view(B, H, W, C).permute(0, 3, 1, 2)


class AttentionBlock(nn.Module):
    """GroupNorm -> fused qkv projection -> heads -> attention -> zero-init
    projection -> residual, on an NCHW map.

    The qkv Dense(3C) output splits into contiguous q|k|v thirds (not the
    OpenAI per-head interleave); the thirds go to ``scaled_attention`` as
    strided [B, N, heads, D] views, with no copy.
    """

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(
                    f"{channels} channels do not split into heads of "
                    f"{num_head_channels}"
                )
            self.heads = channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = zero_init(Dense(channels, channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, N, C)
        qkv = self.qkv(h).view(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.unbind(dim=2)
        out = scaled_attention(q, k, v).reshape(B, N, C)
        out = self.proj_out(out)
        return x + out.view(B, H, W, C).permute(0, 3, 1, 2)
