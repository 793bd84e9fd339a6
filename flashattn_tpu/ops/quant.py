"""Quantized-KV attention: INT8 / FP8 K/V with in-kernel dequantization.

North-star capability beyond the reference (BASELINE.json: "low-precision KV
tiles dequantized inside the kernel"): the KV cache is stored as int8 or
float8_e4m3fn with one f32 scale per token per head. The forward kernel
(:mod:`flashattn_tpu.ops.flash_fwd`) loads the 1-byte payload, folds the K
scales into the score columns and the V scales into the probability columns,
and converts the payload to the query dtype in registers, so K/V
device-memory traffic halves against bf16 for bandwidth-bound decoding.

Inference path (forward only): gradients w.r.t. a quantized cache are not
defined; train with :func:`flashattn_tpu.ops.flash.flash_attention`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.flash import _dispatch_dtype, attention_fwd


class QuantizedKV(NamedTuple):
    k_q: jax.Array      # [B, Hkv, Nk, D] int8 or float8_e4m3fn
    k_scale: jax.Array  # [B, Hkv, Nk] f32
    v_q: jax.Array      # [B, Hkv, Nk, D]
    v_scale: jax.Array  # [B, Hkv, Nk] f32


def _qmax(dtype) -> float:
    dtype = jnp.dtype(dtype)
    if dtype == jnp.dtype(jnp.int8):
        return 127.0
    if dtype == jnp.dtype(jnp.float8_e4m3fn):
        return 448.0
    raise ValueError(f"unsupported KV quant dtype {dtype}")


def quantize_kv(k: jax.Array, v: jax.Array, dtype=jnp.int8) -> QuantizedKV:
    """Per-token symmetric quantization of K and V (`[B, H, N, D]`)."""
    qmax = _qmax(dtype)

    def quant(x):
        xf = x.astype(jnp.float32)
        amax = jnp.max(jnp.abs(xf), axis=-1)
        scale = jnp.maximum(amax, 1e-8) / qmax
        scaled = xf / scale[..., None]
        if jnp.dtype(dtype) == jnp.dtype(jnp.int8):
            q = jnp.clip(jnp.round(scaled), -127, 127).astype(jnp.int8)
        else:
            q = scaled.astype(dtype)
        return q, scale

    k_q, k_s = quant(k)
    v_q, v_s = quant(v)
    return QuantizedKV(k_q, k_s, v_q, v_s)


def dequantize_kv(qkv: QuantizedKV, dtype=jnp.bfloat16):
    k = qkv.k_q.astype(jnp.float32) * qkv.k_scale[..., None]
    v = qkv.v_q.astype(jnp.float32) * qkv.v_scale[..., None]
    return k.astype(dtype), v.astype(dtype)


def flash_attention_quantized(
    q: jax.Array,
    qkv: QuantizedKV,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
    interpret: bool | None = None,
) -> jax.Array:
    """Fused attention over a quantized KV cache (forward only).

    ``q``: full-precision queries; ``qkv``: from :func:`quantize_kv`.
    ``bias``: additive logits bias broadcastable to ``[B, H, Nq, Nk]`` (e.g.
    the not-yet-written-cache-slot mask in decode). Numerics match attention
    over the dequantized cache to f32 round-off — the dequant happens inside
    the kernel, not by materializing bf16 K/V.
    """
    in_dtype = q.dtype
    if layout == "BNHD":
        q = jnp.swapaxes(q, 1, 2)
        qkv = QuantizedKV(
            jnp.swapaxes(qkv.k_q, 1, 2), jnp.swapaxes(qkv.k_scale, 1, 2),
            jnp.swapaxes(qkv.v_q, 1, 2), jnp.swapaxes(qkv.v_scale, 1, 2),
        )
    elif layout != "BHND":
        raise ValueError(f"unknown layout {layout!r}")

    B, Hq, Nq, D = q.shape
    _, Hkv, Nk, _ = qkv.k_q.shape
    if scale is None:
        scale = float(D) ** -0.5
    kdt = _dispatch_dtype(in_dtype)
    q = q.astype(kdt)

    # GQA decode fold (same as flash_attention): tiny-Nq non-causal queries
    # against a GQA cache fold rep q-heads into the Q-tile rows so each
    # quantized KV block is read once instead of rep times. Head-broadcast
    # biases (decode's cache-slot mask) are fold-safe.
    rep_fold = Hq // Hkv
    if rep_fold > 1 and not causal and Nq * rep_fold <= 32:
        bf = bias
        if bf is not None:
            while bf.ndim < 4:
                bf = bf[None]
        if bf is None or bf.shape[1] == 1:
            if bf is not None and bf.shape[2] > 1:
                bf = jnp.tile(bf, (1, 1, rep_fold, 1))
            of = flash_attention_quantized(
                q.reshape(B, Hkv, rep_fold * Nq, D).astype(in_dtype), qkv,
                bias=bf, scale=scale, interpret=interpret)
            of = of.reshape(B, Hq, Nq, D)
            return jnp.swapaxes(of, 1, 2) if layout == "BNHD" else of

    if bias is not None:
        while bias.ndim < 4:
            bias = bias[None]
        bias = jnp.broadcast_to(
            bias, (bias.shape[0], bias.shape[1], bias.shape[2], Nk))
    o, _ = attention_fwd(
        q, qkv.k_q, qkv.v_q, offsets=jnp.zeros((2,), jnp.int32),
        scale=float(scale), causal=bool(causal), bias=bias,
        k_scale=qkv.k_scale, v_scale=qkv.v_scale, return_lse=False,
        interpret=interpret)
    o = o.astype(in_dtype)
    return jnp.swapaxes(o, 1, 2) if layout == "BNHD" else o
