"""Exact-softmax attention oracle.

Role parity: the reference validates every kernel against
``torch.nn.functional.scaled_dot_product_attention`` with the *math* backend
forced (reference precision_test.py:6-8, pure_torch_ver.py:179-215). This module
is that oracle: a direct, unfused softmax(QK^T·s + bias)V in float32, used as
the ground truth for every precision test and bench — plus
:func:`attention_xla`, the same math with matmuls in the input dtype: the
plain version XLA compiles, which a fused kernel has to beat.

Layout convention throughout the package: canonical ``[B, H, N, D]`` ("BHND").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Finite large-negative mask value. -inf produces NaN via exp(-inf - (-inf)) in
# fully-masked rows; the reference dodges this with -30000 in fp16
# (kernel_fp16.cu:29) — we use a dtype-safe fraction of float32 max instead.
DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: tuple[int, int] | None = None,
    segment_ids: tuple[jax.Array, jax.Array] | None = None,
    logit_softcap: float | None = None,
) -> jax.Array:
    """Unfused exact attention in float32 (``Precision.HIGHEST``),
    `[B, H, N, D]` layout.

    Args:
      q: ``[B, H, Nq, D]``.
      k: ``[B, Hkv, Nk, D]`` — ``Hkv`` may divide ``H`` (GQA).
      v: ``[B, Hkv, Nk, D]``.
      bias: optional additive logits bias broadcastable to ``[B, H, Nq, Nk]``.
      causal: mask position pairs where ``kv_pos > q_pos`` (absolute positions,
        i.e. after adding the offsets).
      scale: softmax scale; default ``D ** -0.5`` (reference FlashAttn.py:63-64).
      q_offset / kv_offset: absolute-position offsets of the local q/kv chunks;
        used by sequence-parallel callers so causal masking stays globally
        consistent.
      window: optional sliding window ``(left, right)``: position pair
        (i, j) may attend iff ``i - left <= j <= i + right`` (absolute
        positions); -1 disables that side. Composes with ``causal``.
      segment_ids: packed-sequence masking, ``(q_ids [B, Nq], kv_ids
        [B, Nk])``: (i, j) attends iff ``q_ids[i] == kv_ids[j]`` (ANDed with
        the other masks). A fully-masked row outputs exact zeros — the
        package-wide dead-row convention (the fused kernels store zeros and
        their backward produces zero gradients for such rows).
    Returns:
      ``[B, H, Nq, D]`` in ``q.dtype``.
    """
    return _attention(q, k, v, bias=bias, causal=causal, scale=scale,
                      q_offset=q_offset, kv_offset=kv_offset, window=window,
                      segment_ids=segment_ids, logit_softcap=logit_softcap,
                      mm_dtype=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def attention_xla(q, k, v, **kwargs) -> jax.Array:
    """:func:`attention_reference`'s semantics with both matmuls in the
    input dtype (f32 accumulation, f32 softmax) at default precision: the
    plain attention XLA compiles, materializing the ``[B, H, Nq, Nk]``
    scores. The baseline each hand-written kernel is timed against."""
    return _attention(q, k, v, mm_dtype=q.dtype, precision=None, **kwargs)


def _attention(q, k, v, *, bias=None, causal=False, scale=None, q_offset=0,
               kv_offset=0, window=None, segment_ids=None,
               logit_softcap=None, mm_dtype, precision):
    orig_dtype = q.dtype
    B, H, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    if scale is None:
        scale = float(D) ** -0.5

    qf = q.astype(mm_dtype)
    kf = k.astype(mm_dtype)
    vf = v.astype(mm_dtype)
    if Hkv != H:
        assert H % Hkv == 0, f"GQA requires Hkv | H, got H={H} Hkv={Hkv}"
        rep = H // Hkv
        kf = jnp.repeat(kf, rep, axis=1)
        vf = jnp.repeat(vf, rep, axis=1)

    s = jnp.einsum("bhqd,bhkd->bhqk", qf, kf, precision=precision,
                   preferred_element_type=jnp.float32) * scale
    if logit_softcap is not None:
        # Gemma-2 convention: cap the scaled logits, then add bias/mask.
        s = logit_softcap * jnp.tanh(s / logit_softcap)
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    row_alive = None
    if causal or window is not None or segment_ids is not None:
        q_pos = jnp.arange(Nq)[:, None] + q_offset
        kv_pos = jnp.arange(Nk)[None, :] + kv_offset
        keep = jnp.ones((1, 1, Nq, Nk), bool)
        if causal:
            keep &= (kv_pos <= q_pos)[None, None]
        if window is not None:
            wl, wr = window
            if wl >= 0:
                keep &= (kv_pos >= q_pos - wl)[None, None]
            if wr >= 0:
                keep &= (kv_pos <= q_pos + wr)[None, None]
        if segment_ids is not None:
            seg_q, seg_kv = segment_ids
            keep = keep & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
        # Package-wide dead-row convention: a q row with no unmasked kv
        # position (padding segment, window out of reach, chunk above the
        # causal diagonal) outputs exact zeros — matching the fused kernels.
        row_alive = keep.any(axis=-1, keepdims=True)
        s = jnp.where(keep, s, DEFAULT_MASK_VALUE)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhqk,bhkd->bhqd", p.astype(mm_dtype), vf,
                   precision=precision, preferred_element_type=jnp.float32)
    if row_alive is not None:
        o = jnp.where(row_alive, o, 0.0)
    return o.astype(orig_dtype)


def attention_reference_with_lse(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Like :func:`attention_reference` but also returns the row log-sum-exp.

    The LSE plays the role of the reference's stored ``L = m + log2(l)``
    residual (kernel_fp16.cu:541-542), in natural log. It is the merge
    primitive for ring attention: two partials merge via
    ``L = logaddexp(L1, L2); O = e^{L1-L} O1 + e^{L2-L} O2``.
    """
    B, H, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    if scale is None:
        scale = float(D) ** -0.5
    qf = q.astype(jnp.float32)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if Hkv != H:
        rep = H // Hkv
        kf = jnp.repeat(kf, rep, axis=1)
        vf = jnp.repeat(vf, rep, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", qf, kf,
                   precision=jax.lax.Precision.HIGHEST) * scale
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    if causal:
        q_pos = jnp.arange(Nq)[:, None] + q_offset
        kv_pos = jnp.arange(Nk)[None, :] + kv_offset
        s = jnp.where(kv_pos <= q_pos, s, DEFAULT_MASK_VALUE)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    p = jnp.exp(s - lse[..., None])
    o = jnp.einsum("bhqk,bhkd->bhqd", p, vf,
                   precision=jax.lax.Precision.HIGHEST)
    return o.astype(q.dtype), lse
