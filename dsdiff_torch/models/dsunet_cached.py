"""DSUNetSplit: DSUNet with condition-encoder caching for fast sampling.

Port of the JAX package's ``models/dsunet_cached.py``. The DS-Diff sampler
re-runs all four encoder streams at every reverse step, but three of them
(anatomy / anatomy+lesion / lesion) consume CONDITION images that never
change across the chain: only their FiLM time embedding does. This variant

- separates the noise encoder (``noise_encoder``) from the three condition
  encoders (``cond_encoder_0..2``, or ``cond_encoders`` with a leading [3]
  stream axis under ``stream_mode='vmap'``): the same capacity as DSUNet's
  four encoders;
- ``encode_conditions``: runs the condition streams ONCE at a fixed
  reference timestep and returns their bottleneck features and skip stacks;
- ``denoise_cached``: one reverse step is the noise encoder, the middle
  block, the disentangle heads, the fusion and the decoder against the
  cached condition activations.

Training uses ``forward`` (the full model, per-t condition embeddings).
Caching is then an approximation at sampling time: the condition features
are frozen at one timestep's embedding. With ``cond_t_ref`` set, the
condition encoders see that fixed reference timestep's embedding in
training AND sampling, so ``denoise_cached`` equals ``forward`` exactly,
while the noise stream and the trunk keep the per-t FiLM.

The decoder's skips are ``(noise + sum of the three condition skips) / 4``.
Inside, maps and the cache are NCHW in the compute dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .backbone import StackedUNetEncoder, UNetEncoder
from .dsunet import DSTrunk

__all__ = ["DSUNetSplit", "make_cached_denoiser"]

N_COND = 3  # anatomy, anatomy+lesion, lesion


class DSUNetSplit(DSTrunk):
    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 96,
        out_channels: int = 1,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (8, 16, 32),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 1, 2, 2, 3, 3),
        conv_resample: bool = True,
        num_heads: int = 8,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = False,
        stream_mode: str = "sequential",
        cond_t_ref: float | None = None,
        use_edge: bool = False,
        remat: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if stream_mode not in ("sequential", "vmap"):
            raise ValueError(f"unknown stream_mode '{stream_mode}'")
        self.stream_mode = stream_mode
        self.cond_t_ref = cond_t_ref
        self.use_edge = use_edge
        kw = dict(
            model_channels=model_channels,
            num_res_blocks=num_res_blocks,
            attention_resolutions=tuple(attention_resolutions),
            dropout=dropout,
            channel_mult=tuple(channel_mult),
            conv_resample=conv_resample,
            num_heads=num_heads,
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown,
            remat=remat,
            dtype=dtype,
        )
        # the edge map joins the noise encoder's input only
        self.noise_encoder = UNetEncoder(2 if use_edge else 1, **kw)
        if stream_mode == "sequential":
            for s in range(N_COND):
                self.add_module(f"cond_encoder_{s}", UNetEncoder(1, **kw))
        else:
            self.cond_encoders = StackedUNetEncoder(N_COND, 1, **kw)
        self._build_trunk(self.noise_encoder, out_channels, kw)

    # ------------------------------------------------------------- pieces
    def _cond_emb(self, emb: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Embedding fed to the condition encoders: the per-t ``emb`` unless
        ``cond_t_ref`` pins them to a fixed reference timestep."""
        if self.cond_t_ref is None:
            return emb
        return self.time_embed(torch.full_like(t, self.cond_t_ref,
                                               dtype=torch.float32))

    def _encode_cond_streams(self, streams, emb):
        """streams: three NCHW maps -> (h_cond [3, B, ...], skips: list of
        [3, B, ...])."""
        if self.stream_mode == "sequential":
            outs = [getattr(self, f"cond_encoder_{s}")(streams[s], emb)
                    for s in range(N_COND)]
        else:
            outs = self.cond_encoders.encode_streams(streams, emb)
        h_cond = torch.stack([o[0] for o in outs])
        skips_cond = [torch.stack(parts)
                      for parts in zip(*[o[1] for o in outs])]
        return h_cond, skips_cond

    @staticmethod
    def sum_cond_skips(cache) -> list[torch.Tensor]:
        """The condition streams' share of the decoder's skips: each cached
        stack [3, B, ...] summed over its streams. Constant over a request,
        so a sampler computes it once and hands it to ``denoise_cached``."""
        return [sc.sum(dim=0) for sc in cache[1]]

    def _decode(self, h_n, skips_n, cache, emb, skip_sums=None):
        if skip_sums is None:
            skip_sums = self.sum_cond_skips(cache)
        # skips: mean of the noise stream and the 3 condition streams
        skips = [(sn + sc) / 4.0 for sn, sc in zip(skips_n, skip_sums)]
        return self._fuse_and_decode(h_n, cache[0].unbind(0), skips, emb)

    def encode_conditions(self, cond: torch.Tensor, t_ref: torch.Tensor):
        """cond: [B, H, W, 3] NHWC (a, al, l); t_ref: [B]. Returns the cache
        ``(h_cond [3, B, C, h, w], skips: list of [3, B, C, h, w])``.

        Run once per sample call at a fixed reference timestep (overridden
        by ``cond_t_ref`` when set, so training and the cache agree).
        """
        if self.cond_t_ref is not None:
            t_ref = torch.full_like(t_ref, self.cond_t_ref,
                                    dtype=torch.float32)
        emb = self.time_embed(t_ref)
        x = cond.permute(0, 3, 1, 2)
        # a fourth channel (the edge map, under use_edge) belongs to the
        # noise stream, not to the condition encoders
        return self._encode_cond_streams(
            [x[:, i : i + 1] for i in range(N_COND)], emb
        )

    def denoise_cached(self, x_noise: torch.Tensor, t: torch.Tensor, cache,
                       skip_sums: list[torch.Tensor] | None = None):
        """One step against cached condition activations.

        x_noise: [B, H, W, 1] NHWC, or [B, H, W, 2] ([noise, edge]) under
        ``use_edge``; cache: what ``encode_conditions`` returned;
        skip_sums: ``sum_cond_skips(cache)`` where the caller keeps it across
        steps (computed here otherwise). Returns (out [B, H, W, out] f32,
        features).
        """
        emb = self.time_embed(t)
        h_n, skips_n = self.noise_encoder(x_noise.permute(0, 3, 1, 2), emb)
        h_n = self.middle(h_n, emb)
        return self._decode(h_n, skips_n, cache, emb, skip_sums)

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        """The full model (training; per-t condition embeddings).

        x: [B, H, W, 4] NHWC = [noise, a, al, l], or [B, H, W, 5] =
        [noise, a, al, l, edge] under ``use_edge``; t: [B]. Returns
        (out [B, H, W, out] f32, features).
        """
        want = 5 if self.use_edge else 4
        if x.shape[-1] != want:
            raise ValueError(
                f"DSUNetSplit(use_edge={self.use_edge}) expects {want} "
                f"channels, got {x.shape[-1]}"
            )
        x = x.permute(0, 3, 1, 2)
        emb = self.time_embed(t)
        x_n = torch.cat([x[:, 0:1], x[:, 4:5]], dim=1) if self.use_edge \
            else x[:, 0:1]
        h_n, skips_n = self.noise_encoder(x_n, emb)
        h_n = self.middle(h_n, emb)
        cache = self._encode_cond_streams(
            [x[:, i : i + 1] for i in (1, 2, 3)], self._cond_emb(emb, t)
        )
        return self._decode(h_n, skips_n, cache, emb)


def make_cached_denoiser(model: DSUNetSplit, cond: torch.Tensor,
                         t_ref: float = 500.0):
    """A ``(x_noise, t_model) -> output`` denoiser with the condition
    encoders evaluated once, here, under ``torch.inference_mode``.

    cond: [B, H, W, 3] NHWC, or [B, H, W, 4] = [a, al, l, edge] under
    ``use_edge``: the edge channel is peeled off and joined to every step's
    noise input (it is static across the reverse chain, like the
    conditions)."""
    B = cond.shape[0]
    edge = None
    if model.use_edge:
        edge = cond[..., 3:4]
        cond = cond[..., :3]
    with torch.inference_mode():
        cache = model.encode_conditions(
            cond, torch.full((B,), t_ref, dtype=torch.float32,
                             device=cond.device)
        )
        skip_sums = model.sum_cond_skips(cache)

    def denoise(x, t_model):
        xin = x if edge is None else torch.cat([x, edge], dim=-1)
        out, _feats = model.denoise_cached(xin, t_model, cache, skip_sums)
        return out

    return denoise
