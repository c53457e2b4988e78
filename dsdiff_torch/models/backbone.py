"""U-Net encoder / middle / decoder components.

Port of the JAX package's ``models/backbone.py:31-176``. The attention
after a res block is an ``AttentionBlock``, or with
``use_spatial_transformer`` a ``SpatialTransformer`` of
``transformer_depth`` blocks (``FFTAttention`` with ``use_fft_attention``;
heads from ``num_heads``, or ``ch // num_head_channels``), which reads the
``context`` the encoder, middle and decoder pass down (tokens of width
``context_dim``; without one its second attention is self-attention too).
With ``remat``, each ``ResBlock`` (and only it, as in the JAX package) runs
under activation checkpointing while the module trains with grad enabled;
serving and ``torch.inference_mode`` never checkpoint.
Submodules carry the Flax names (``down_{level}_{i}_res``, ``mid_attn``,
``up_{level}_us``, ...). ``StackedUNetEncoder`` holds the encoders of
several streams in the ``stream_mode='vmap'`` layout. Maps are NCHW. Unlike
Flax, a PyTorch layer needs its input width up front, so each component
takes its ``in_channels`` and records the widths it produces.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .attention import AttentionBlock, SpatialTransformer
from .layers import Conv, Downsample, GroupNorm32, ResBlock, Upsample, zero_init

__all__ = ["UNetEncoder", "StackedUNetEncoder", "UNetMiddle", "UNetDecoder",
           "OutHead"]


def _remat(fn, *args):
    """``fn(*args)`` in a ``model.remat`` span: ``checkpoint`` runs it in the
    forward and again when the backward recomputes the block."""
    with span("model.remat"):
        return fn(*args)


class _Common(nn.Module):
    def __init__(
        self,
        model_channels: int = 96,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 8),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_spatial_transformer: bool = False,
        transformer_depth: int = 1,
        use_fft_attention: bool = False,
        context_dim: int | None = None,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.dropout = dropout
        self.channel_mult = tuple(channel_mult)
        self.conv_resample = conv_resample
        self.num_heads = num_heads
        self.num_head_channels = num_head_channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.resblock_updown = resblock_updown
        self.use_spatial_transformer = use_spatial_transformer
        self.transformer_depth = transformer_depth
        self.use_fft_attention = use_fft_attention
        self.context_dim = context_dim
        self.remat = remat
        # the timestep embedding's width, as every U-Net family builds it
        self.emb_dim = 4 * model_channels
        self.dtype = dtype
        # forward order: (name, kind), kind res | attn | transformer | resample
        self.plan: list[tuple[str, str]] = []
        # True where the parameters carry a leading stream axis and a forward
        # runs on one stream's slices (``StackedUNetEncoder``)
        self.stacked = False

    def _add(self, name: str, kind: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.plan.append((name, kind))

    def _res(self, name: str, ch: int, out_ch: int, **kw) -> None:
        self._add(name, "res", ResBlock(
            ch, self.emb_dim, out_ch, dropout=self.dropout,
            use_scale_shift_norm=self.use_scale_shift_norm, dtype=self.dtype,
            **kw,
        ))

    def _attn(self, name: str, ch: int) -> None:
        if not self.use_spatial_transformer:
            self._add(name, "attn", AttentionBlock(
                ch, self.num_heads, self.num_head_channels, dtype=self.dtype
            ))
            return
        heads = (self.num_heads if self.num_head_channels == -1
                 else ch // self.num_head_channels)
        self._add(name, "transformer", SpatialTransformer(
            ch, depth=self.transformer_depth, heads=heads,
            dim_head=ch // heads, dropout=self.dropout,
            use_fft=self.use_fft_attention, context_dim=self.context_dim,
            dtype=self.dtype,
        ))

    def _run(self, name: str, kind: str, h: torch.Tensor, emb: torch.Tensor,
             context: torch.Tensor | None = None):
        block = getattr(self, name)
        if kind == "transformer":
            return block(h, context)
        if kind != "res":
            return block(h)
        # a dropout mask is drawn here, outside any checkpoint, so that the
        # recompute in backward applies the same one
        mask = block.dropout_mask(h) if block.drops() else None
        if self.remat and self.training and torch.is_grad_enabled():
            if self.stacked:
                # the stream's slices, bound again when backward recomputes
                params = dict(block.named_parameters())
                return checkpoint(_remat, functional_call, block, params,
                                  (h, emb, mask), use_reentrant=False)
            return checkpoint(_remat, block, h, emb, mask, use_reentrant=False)
        return block(h, emb, mask)


class UNetEncoder(_Common):
    """in-conv + down stages; ``forward`` returns (h, skips) with one skip
    per block. ``skip_channels`` and ``out_channels`` record the widths."""

    def __init__(self, in_channels: int, **kw):
        super().__init__(**kw)
        ch0 = self.model_channels
        self.in_conv = Conv(in_channels, ch0, 3, padding=1, dtype=self.dtype)
        self.skip_channels = [ch0]
        self.skip_after: set[str] = set()
        ch, ds = ch0, 1
        last = len(self.channel_mult) - 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(self.num_res_blocks):
                self._res(f"down_{level}_{i}_res", ch, mult * ch0)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    self._attn(f"down_{level}_{i}_attn", ch)
                self.skip_after.add(self.plan[-1][0])
                self.skip_channels.append(ch)
            if level != last:
                name = f"down_{level}_ds"
                if self.resblock_updown:
                    self._res(name, ch, ch, down=True)
                else:
                    self._add(name, "resample", Downsample(
                        ch, self.conv_resample, dtype=self.dtype
                    ))
                self.skip_after.add(name)
                self.skip_channels.append(ch)
                ds *= 2
        self.out_channels = ch

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                context: torch.Tensor | None = None):
        h = self.in_conv(x)
        skips = [h]
        for name, kind in self.plan:
            h = self._run(name, kind, h, emb, context)
            if name in self.skip_after:
                skips.append(h)
        return h, skips


class StackedUNetEncoder(UNetEncoder):
    """``n_streams`` encoders held as one: every parameter carries a leading
    stream axis (the layout of the JAX package's ``stream_mode='vmap'``),
    each stream initialised on its own. ``encode_streams`` runs stream ``s``
    as a plain ``UNetEncoder`` forward on slice ``s`` of every parameter."""

    def __init__(self, n_streams: int, in_channels: int, **kw):
        super().__init__(in_channels, **kw)
        others = [dict(UNetEncoder(in_channels, **kw).named_parameters())
                  for _ in range(n_streams - 1)]
        for mod_name, mod in self.named_modules():
            for leaf, p in mod._parameters.items():
                if p is None:
                    continue
                name = f"{mod_name}.{leaf}" if mod_name else leaf
                mod._parameters[leaf] = nn.Parameter(torch.stack(
                    [p.detach()] + [o[name].detach() for o in others]
                ))
        self.n_streams = n_streams
        self.stacked = True

    def encode_streams(self, streams: Sequence[torch.Tensor],
                       emb: torch.Tensor,
                       context: torch.Tensor | None = None):
        """One (h, skips) per stream, in order."""
        if len(streams) != self.n_streams:
            raise ValueError(
                f"{len(streams)} streams for {self.n_streams} stacked encoders"
            )
        params = dict(self.named_parameters())
        return [
            functional_call(self, {n: p[s] for n, p in params.items()},
                            (x, emb, context))
            for s, x in enumerate(streams)
        ]


class UNetMiddle(_Common):
    """res - attn - res bottleneck."""

    def __init__(self, channels: int, **kw):
        super().__init__(**kw)
        self._res("mid_res1", channels, channels)
        self._attn("mid_attn", channels)
        self._res("mid_res2", channels, channels)

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        for name, kind in self.plan:
            h = self._run(name, kind, h, emb, context)
        return h


class UNetDecoder(_Common):
    """Up stages consuming the skip stack from its end; each res block takes
    ``cat([h, skip])``. ``skip_channels`` are the encoder's."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int], **kw):
        super().__init__(**kw)
        skip_ch = list(skip_channels)
        ch0 = self.model_channels
        ch = in_channels
        ds = 2 ** (len(self.channel_mult) - 1)
        self.takes_skip: set[str] = set()
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                name = f"up_{level}_{i}_res"
                self._res(name, ch + skip_ch.pop(), mult * ch0)
                self.takes_skip.add(name)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    self._attn(f"up_{level}_{i}_attn", ch)
                if level and i == self.num_res_blocks:
                    name = f"up_{level}_us"
                    if self.resblock_updown:
                        self._res(name, ch, ch, up=True)
                    else:
                        self._add(name, "resample", Upsample(
                            ch, self.conv_resample, dtype=self.dtype
                        ))
                    ds //= 2
        if skip_ch:
            raise ValueError("skip stack does not match the decoder")
        self.out_channels = ch

    def forward(self, h: torch.Tensor, skips: Sequence[torch.Tensor],
                emb: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        skips = list(skips)
        for name, kind in self.plan:
            if name in self.takes_skip:
                h = torch.cat([h, skips.pop().to(h.dtype)], dim=1)
            h = self._run(name, kind, h, emb, context)
        if skips:
            raise ValueError("skip stack should be empty")
        return h


class OutHead(nn.Module):
    """GN + SiLU + zero-init 3x3 out conv; returns f32."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm32(in_channels)
        self.conv = zero_init(
            Conv(in_channels, out_channels, 3, padding=1, dtype=dtype)
        )

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.silu(self.norm(h))).float()
