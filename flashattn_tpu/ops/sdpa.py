"""Drop-in scaled_dot_product_attention adapter.

Role parity: the reference is consumed as an SDPA replacement inside Stable
Diffusion attention layers (README.md:31-37; FlashAttn.py wraps the kernels in
``torch.autograd.Function`` with the SDPA-ish signature
``(q, k, v, mask, causal, scale, BNHD_fmt)``, FlashAttn.py:45-67). This module
exposes the same contract for JAX models — including a *working* additive
``attn_mask`` (the reference accepts but ignores it, FlashAttn.py:49) and a
boolean mask variant.

``impl="auto"`` is the fused kernel for every shape: timed on the H100
(PERF.md "Kernel decisions"), it beats plain XLA 4-5× on the U-Net's
self-attention, and on the 77-token cross-attention the two are within 11%
either way (XLA ahead on the forward, the kernel on forward+backward).
``"exact"`` forces the materialized-softmax path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.flash import flash_attention
from flashattn_tpu.ops.oracle import DEFAULT_MASK_VALUE, attention_reference


def scaled_dot_product_attention(
    query: jax.Array,
    key: jax.Array,
    value: jax.Array,
    attn_mask: jax.Array | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    *,
    layout: str = "BHND",
    impl: str = "auto",
    interpret: bool | None = None,
) -> jax.Array:
    """torch.nn.functional.scaled_dot_product_attention semantics on Pallas.

    ``attn_mask``: boolean (True = attend) or additive float, broadcastable to
    ``[B, H, Nq, Nk]``; ranks < 4 are left-padded with size-1 dims.
    ``impl``: "auto" or "fused" (the kernel), or "exact". The exact path
    materializes the full [Nq, Nk] score matrix (O(N·Nk) memory, f32).
    ``interpret`` applies to both paths (exact ignores it semantically but
    accepts it for call-site symmetry).
    """
    bias = None
    if attn_mask is not None:
        mask = attn_mask
        while mask.ndim < 4:
            mask = mask[None]
        if mask.dtype == jnp.bool_:
            bias = jnp.where(mask, 0.0, DEFAULT_MASK_VALUE).astype(jnp.float32)
        else:
            bias = mask

    if impl not in ("auto", "fused", "exact"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "exact":
        q, k, v = query, key, value
        if layout == "BNHD":
            q, k, v = (x.swapaxes(1, 2) for x in (q, k, v))
        o = attention_reference(q, k, v, bias=bias, causal=is_causal,
                                scale=scale)
        return o.swapaxes(1, 2) if layout == "BNHD" else o

    return flash_attention(
        query, key, value,
        bias=bias, causal=is_causal, scale=scale, layout=layout,
        interpret=interpret,
    )
