"""SD-style latent-diffusion U-Net on the fused attention engine.

The reference's headline numbers are Stable Diffusion it/s with its kernel
dropped into the U-Net's attention (README.md:104-154; SD1.5 and SDXL shapes
in BASELINE.md). This module is that model family on this engine: a
latent U-Net with ResBlocks + SpatialTransformer blocks (self-attention +
cross-attention + GEGLU), structurally mirroring the SD1.5/SDXL U-Nets, with
every attention routed through :func:`flashattn_tpu.ops.sdpa
.scaled_dot_product_attention` in its native ``[B, N, H, D]`` layout.

Channels/attention shapes at `sd15()` defaults reproduce SD1.5's attention
workload (e.g. 4096×4096 self-attention with D=40..160 per head at 512²).
Pure-pytree params; NHWC convs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.sdpa import scaled_dot_product_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_levels: Sequence[int] = (0, 1, 2)   # levels with transformer blocks
    # int = uniform; or one entry per level (SDXL uses (1, 2, 10))
    transformer_depth: int | Sequence[int] = 1
    num_heads: int = 8
    # if set, heads are computed as C // head_dim per level (SDXL: 64)
    head_dim: int | None = None
    context_dim: int = 768
    groups: int = 32
    dtype: Any = jnp.bfloat16
    # SD zero-initializes residual-branch output projections; disable for
    # gradient-flow tests (at zero-init, upstream grads are exactly zero).
    zero_init: bool = True

    def depth_at(self, level: int) -> int:
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            assert channels % self.head_dim == 0, (channels, self.head_dim)
            return channels // self.head_dim
        return self.num_heads

    @staticmethod
    def sd15():
        """SD1.5 U-Net shape class (README.md:114-123 workload)."""
        return UNetConfig()

    @staticmethod
    def sdxl():
        """SDXL-base U-Net shape class (README.md:126-132 workload):
        attention only at the 2× and 4× levels, per-level transformer depth
        (1, 2, 10), fixed 64-dim heads, 2048-dim text conditioning."""
        return UNetConfig(
            channel_mult=(1, 2, 4), attn_levels=(1, 2),
            transformer_depth=(1, 2, 10), head_dim=64, context_dim=2048,
        )

    @staticmethod
    def tiny():
        """CI-sized config (same structure, minutes→seconds)."""
        return UNetConfig(
            model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attn_levels=(0, 1), num_heads=2, context_dim=32, groups=8,
            dtype=jnp.float32, zero_init=False,
        )


# ───────────────────────────── primitives ───────────────────────────────────


def _conv(params, x, stride=1):
    y = jax.lax.conv_general_dilated(
        x, params["w"].astype(x.dtype),
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + params["b"].astype(x.dtype)


def _dense(params, x):
    return x @ params["w"].astype(x.dtype) + params["b"].astype(x.dtype)


def _group_norm(x, params, groups, eps=1e-5):
    B, H, W, C = x.shape
    xf = x.astype(jnp.float32).reshape(B, H * W, groups, C // groups)
    mean = xf.mean(axis=(1, 3), keepdims=True)
    var = xf.var(axis=(1, 3), keepdims=True)
    xf = (xf - mean) * jax.lax.rsqrt(var + eps)
    xf = xf.reshape(B, H, W, C)
    return (xf * params["scale"] + params["bias"]).astype(x.dtype)


def _layer_norm(x, params, eps=1e-5):
    xf = x.astype(jnp.float32)
    mean = xf.mean(axis=-1, keepdims=True)
    var = xf.var(axis=-1, keepdims=True)
    xf = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (xf * params["scale"] + params["bias"]).astype(x.dtype)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal timestep embedding, [B] -> [B, dim]."""
    half = dim // 2
    freqs = jnp.exp(-math.log(max_period) * jnp.arange(half, dtype=jnp.float32)
                    / half)
    args = t.astype(jnp.float32)[:, None] * freqs[None]
    return jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)


# ───────────────────────────── init helpers ─────────────────────────────────


def _init_conv(key, cin, cout, ksize, dtype, zero=False):
    if zero:
        w = jnp.zeros((ksize, ksize, cin, cout), jnp.float32)
    else:
        fan_in = cin * ksize * ksize
        w = jax.random.normal(key, (ksize, ksize, cin, cout), jnp.float32)
        w = w * (fan_in ** -0.5)
    return {"w": w.astype(dtype), "b": jnp.zeros((cout,), dtype)}


def _init_dense(key, cin, cout, dtype, zero=False):
    if zero:
        w = jnp.zeros((cin, cout), jnp.float32)
    else:
        w = jax.random.normal(key, (cin, cout), jnp.float32) * (cin ** -0.5)
    return {"w": w.astype(dtype), "b": jnp.zeros((cout,), dtype)}


def _init_norm(c):
    return {"scale": jnp.ones((c,), jnp.float32),
            "bias": jnp.zeros((c,), jnp.float32)}


def _init_resblock(key, cin, cout, temb_dim, dtype, zero_init=True):
    ks = jax.random.split(key, 4)
    p = {
        "norm1": _init_norm(cin),
        "conv1": _init_conv(ks[0], cin, cout, 3, dtype),
        "temb": _init_dense(ks[1], temb_dim, cout, dtype),
        "norm2": _init_norm(cout),
        "conv2": _init_conv(ks[2], cout, cout, 3, dtype, zero=zero_init),
    }
    if cin != cout:
        p["skip"] = _init_conv(ks[3], cin, cout, 1, dtype)
    return p


def _init_attn(key, c, heads, ctx_dim, dtype):
    ks = jax.random.split(key, 4)
    return {
        "wq": _init_dense(ks[0], c, c, dtype),
        "wk": _init_dense(ks[1], ctx_dim, c, dtype),
        "wv": _init_dense(ks[2], ctx_dim, c, dtype),
        "wo": _init_dense(ks[3], c, c, dtype),
    }


def _init_tblock(key, c, heads, ctx_dim, dtype):
    ks = jax.random.split(key, 5)
    return {
        "ln1": _init_norm(c),
        "attn1": _init_attn(ks[0], c, heads, c, dtype),      # self
        "ln2": _init_norm(c),
        "attn2": _init_attn(ks[1], c, heads, ctx_dim, dtype),  # cross
        "ln3": _init_norm(c),
        "ff_in": _init_dense(ks[2], c, 8 * c, dtype),        # GEGLU: 2×4c
        "ff_out": _init_dense(ks[3], 4 * c, c, dtype),
    }


def _init_spatial_transformer(key, c, heads, depth, ctx_dim, dtype, zero_init=True):
    ks = jax.random.split(key, depth + 2)
    return {
        "norm": _init_norm(c),
        "proj_in": _init_dense(ks[0], c, c, dtype),
        "blocks": [
            _init_tblock(ks[1 + i], c, heads, ctx_dim, dtype)
            for i in range(depth)
        ],
        "proj_out": _init_dense(ks[-1], c, c, dtype, zero=zero_init),
    }


def init_unet(key, cfg: UNetConfig):
    mc = cfg.model_channels
    temb_dim = 4 * mc
    keys = iter(jax.random.split(key, 4096))

    def nk():
        return next(keys)

    params = {
        "time_mlp1": _init_dense(nk(), mc, temb_dim, cfg.dtype),
        "time_mlp2": _init_dense(nk(), temb_dim, temb_dim, cfg.dtype),
        "conv_in": _init_conv(nk(), cfg.in_channels, mc, 3, cfg.dtype),
    }

    downs, ch, level_ch = [], mc, [mc]
    for level, mult in enumerate(cfg.channel_mult):
        cout = mc * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _init_resblock(nk(), ch, cout, temb_dim, cfg.dtype, cfg.zero_init)}
            if level in cfg.attn_levels:
                blk["attn"] = _init_spatial_transformer(
                    nk(), cout, cfg.heads_for(cout), cfg.depth_at(level),
                    cfg.context_dim, cfg.dtype, cfg.zero_init)
            blocks.append(blk)
            ch = cout
            level_ch.append(ch)
        down = {"blocks": blocks}
        if level < len(cfg.channel_mult) - 1:
            down["downsample"] = _init_conv(nk(), ch, ch, 3, cfg.dtype)
            level_ch.append(ch)
        downs.append(down)
    params["downs"] = downs

    mid_depth = cfg.depth_at(len(cfg.channel_mult) - 1)
    params["mid"] = {
        "res1": _init_resblock(nk(), ch, ch, temb_dim, cfg.dtype, cfg.zero_init),
        "attn": _init_spatial_transformer(
            nk(), ch, cfg.heads_for(ch), mid_depth,
            cfg.context_dim, cfg.dtype, cfg.zero_init),
        "res2": _init_resblock(nk(), ch, ch, temb_dim, cfg.dtype, cfg.zero_init),
    }

    ups = []
    for level in reversed(range(len(cfg.channel_mult))):
        cout = mc * cfg.channel_mult[level]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            skip = level_ch.pop()
            blk = {"res": _init_resblock(nk(), ch + skip, cout, temb_dim,
                                         cfg.dtype, cfg.zero_init)}
            if level in cfg.attn_levels:
                blk["attn"] = _init_spatial_transformer(
                    nk(), cout, cfg.heads_for(cout), cfg.depth_at(level),
                    cfg.context_dim, cfg.dtype, cfg.zero_init)
            blocks.append(blk)
            ch = cout
        up = {"blocks": blocks}
        if level > 0:
            up["upsample"] = _init_conv(nk(), ch, ch, 3, cfg.dtype)
        ups.append(up)
    params["ups"] = ups

    params["norm_out"] = _init_norm(ch)
    params["conv_out"] = _init_conv(nk(), ch, cfg.out_channels, 3, cfg.dtype,
                                    zero=cfg.zero_init)
    return params


# ───────────────────────────── forward ──────────────────────────────────────


def _resblock(p, x, temb, groups):
    h = _conv(p["conv1"], jax.nn.silu(
        _group_norm(x, p["norm1"], groups).astype(jnp.float32)).astype(x.dtype))
    h = h + _dense(p["temb"], jax.nn.silu(temb))[:, None, None, :].astype(h.dtype)
    h = _conv(p["conv2"], jax.nn.silu(
        _group_norm(h, p["norm2"], groups).astype(jnp.float32)).astype(h.dtype))
    skip = _conv(p["skip"], x) if "skip" in p else x
    return skip + h


def _mha(p, x, ctx, heads, interpret, attn_impl="fused"):
    """x [B, N, C] (queries), ctx [B, M, Cctx] (keys/values).

    ``attn_impl``: "fused" routes through the Pallas engine; "xla" computes
    exact unfused softmax attention — the bench baseline playing the
    reference's "PyTorch SDPA math backend" role (BASELINE.md SD rows).
    """
    B, N, C = x.shape
    d = C // heads
    q = _dense(p["wq"], x).reshape(B, N, heads, d)
    k = _dense(p["wk"], ctx).reshape(B, ctx.shape[1], heads, d)
    v = _dense(p["wv"], ctx).reshape(B, ctx.shape[1], heads, d)
    if attn_impl == "xla":
        from flashattn_tpu.ops.oracle import attention_reference

        o = attention_reference(
            q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2)
        ).swapaxes(1, 2)
    else:
        o = scaled_dot_product_attention(q, k, v, layout="BNHD",
                                         interpret=interpret)
    return _dense(p["wo"], o.reshape(B, N, C))


def _tblock(p, x, ctx, heads, interpret, attn_impl):
    x = x + _mha(p["attn1"], _layer_norm(x, p["ln1"]), _layer_norm(x, p["ln1"]),
                 heads, interpret, attn_impl)
    x = x + _mha(p["attn2"], _layer_norm(x, p["ln2"]), ctx, heads, interpret,
                 attn_impl)
    h = _dense(p["ff_in"], _layer_norm(x, p["ln3"]))
    a, g = jnp.split(h, 2, axis=-1)
    x = x + _dense(p["ff_out"], a * jax.nn.gelu(g.astype(jnp.float32))
                   .astype(a.dtype))
    return x


def _spatial_transformer(p, x, ctx, cfg, interpret, attn_impl):
    B, H, W, C = x.shape
    heads = cfg.heads_for(C)
    h = _group_norm(x, p["norm"], cfg.groups)
    h = _dense(p["proj_in"], h.reshape(B, H * W, C))
    for blk in p["blocks"]:
        h = _tblock(blk, h, ctx, heads, interpret, attn_impl)
    h = _dense(p["proj_out"], h).reshape(B, H, W, C)
    return x + h


def unet_forward(params, x, t, context, cfg: UNetConfig, *, interpret=None,
                 attn_impl="fused"):
    """Denoise step: latents ``x [B,H,W,Cin]``, timesteps ``t [B]``,
    text conditioning ``context [B, M, ctx_dim]`` → ``eps [B,H,W,Cout]``."""
    temb = timestep_embedding(t, cfg.model_channels)
    temb = _dense(params["time_mlp2"],
                  jax.nn.silu(_dense(params["time_mlp1"],
                                     temb.astype(cfg.dtype))
                              .astype(jnp.float32)).astype(cfg.dtype))

    x = x.astype(cfg.dtype)
    context = context.astype(cfg.dtype)
    h = _conv(params["conv_in"], x)
    skips = [h]
    for level, down in enumerate(params["downs"]):
        for blk in down["blocks"]:
            h = _resblock(blk["res"], h, temb, cfg.groups)
            if "attn" in blk:
                h = _spatial_transformer(blk["attn"], h, context, cfg,
                                         interpret, attn_impl)
            skips.append(h)
        if "downsample" in down:
            h = _conv(down["downsample"], h, stride=2)
            skips.append(h)

    h = _resblock(params["mid"]["res1"], h, temb, cfg.groups)
    h = _spatial_transformer(params["mid"]["attn"], h, context, cfg,
                             interpret, attn_impl)
    h = _resblock(params["mid"]["res2"], h, temb, cfg.groups)

    for up in params["ups"]:
        for blk in up["blocks"]:
            h = jnp.concatenate([h, skips.pop()], axis=-1)
            h = _resblock(blk["res"], h, temb, cfg.groups)
            if "attn" in blk:
                h = _spatial_transformer(blk["attn"], h, context, cfg,
                                         interpret, attn_impl)
        if "upsample" in up:
            B, H, W, C = h.shape
            h = jax.image.resize(h, (B, 2 * H, 2 * W, C), "nearest")
            h = _conv(up["upsample"], h)

    h = jax.nn.silu(_group_norm(h, params["norm_out"], cfg.groups)
                    .astype(jnp.float32)).astype(h.dtype)
    return _conv(params["conv_out"], h).astype(jnp.float32)
