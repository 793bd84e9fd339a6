"""Golden model: tiled FlashAttention-2 forward/backward in pure ``jnp``.

Role parity: the reference keeps a tensor-level tiled implementation,
``pure_torch_ver.py`` (online softmax at :71-79, ``L = m + log(l)`` at :84-85,
full backward with recompute at :125-152), as the "mathematically clean spec"
its HIP kernels are validated against. This module is that spec here —
same tiling algebra, written as ``lax.scan`` over KV/Q tiles so it
jits, runs on CPU, and serves as the differential-testing anchor for the
Pallas kernels.

Intentional fixes vs the reference kernels (SURVEY.md §6 quirks — the *spec*
here is the clean math, matching pure_torch_ver.py:150-152):
  * symmetric dQ/dK scaling (reference bwd leaves dQ scaled by log2(e),
    kernel_fp16.cu:736),
  * no cross-tile races (pure functional accumulation),
  * masking with a large negative in f32, never read-then-mask of OOB rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.oracle import DEFAULT_MASK_VALUE


class _FwdTiled(NamedTuple):
    o: jax.Array
    lse: jax.Array


def _pad_to(x: jax.Array, axis: int, multiple: int) -> jax.Array:
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


@functools.partial(
    jax.jit,
    static_argnames=(
        "causal", "scale", "block_q", "block_k", "has_bias", "window"
    ),
)
def _fwd_tiled(q, k, v, bias, *, causal, scale, block_q, block_k, has_bias,
               window=None):
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    Tq = -(-Nq // block_q)
    Tk = -(-Nk // block_k)
    Nqp, Nkp = Tq * block_q, Tk * block_k

    qf = _pad_to(q.astype(jnp.float32), 2, block_q) * scale
    kf = _pad_to(k.astype(jnp.float32), 2, block_k)
    vf = _pad_to(v.astype(jnp.float32), 2, block_k)
    # [Tq, B, H, block, ...] tile-major arrangement for scan. The zero-bias
    # path materializes NO [Nq, Nk] tensor — this model is the O(N)-memory
    # oracle for shapes where the unfused oracle cannot fit.
    q_tiles = qf.reshape(B, H, Tq, block_q, D).transpose(2, 0, 1, 3, 4)
    k_tiles = kf.reshape(B, H, Tk, block_k, D).transpose(2, 0, 1, 3, 4)
    v_tiles = vf.reshape(B, H, Tk, block_k, D).transpose(2, 0, 1, 3, 4)
    if has_bias:
        bf = jnp.broadcast_to(bias.astype(jnp.float32), (B, H, Nq, Nk))
        bf = _pad_to(_pad_to(bf, 2, block_q), 3, block_k)
        b_tiles = bf.reshape(
            B, H, Tq, block_q, Tk, block_k).transpose(2, 4, 0, 1, 3, 5)
    else:
        b_tiles = jnp.zeros((Tq, Tk, 1, 1, 1, 1), jnp.float32)

    kv_valid = jnp.arange(Nkp) < Nk  # mask padded KV columns

    def q_tile_step(q_idx, qi_bi):
        qi, bi = qi_bi  # qi: [B,H,bq,D]; bi: [Tk,B,H,bq,bk]

        def kv_tile_step(carry, inputs):
            m_prev, l_prev, acc = carry
            kv_idx, kj, vj, bij = inputs
            s = jnp.einsum("bhqd,bhkd->bhqk", qi, kj,
                           precision=jax.lax.Precision.HIGHEST) + bij
            col_valid = jax.lax.dynamic_slice_in_dim(
                kv_valid, kv_idx * block_k, block_k
            )
            mask = jnp.broadcast_to(col_valid[None, :], (block_q, block_k))
            if causal or window is not None:
                q_pos = q_idx * block_q + jnp.arange(block_q)[:, None]
                kv_pos = kv_idx * block_k + jnp.arange(block_k)[None, :]
                if causal:
                    mask = mask & (kv_pos <= q_pos)
                if window is not None:
                    wl, wr = window
                    if wl >= 0:
                        mask = mask & (kv_pos >= q_pos - wl)
                    if wr >= 0:
                        mask = mask & (kv_pos <= q_pos + wr)
            s = jnp.where(mask[None, None], s, DEFAULT_MASK_VALUE)
            # Online softmax update (reference fwd hot loop kernel_fp16.cu:381-508).
            m_cur = jnp.max(s, axis=-1)
            m_next = jnp.maximum(m_prev, m_cur)
            alpha = jnp.exp(m_prev - m_next)
            p = jnp.exp(s - m_next[..., None])
            l_next = alpha * l_prev + jnp.sum(p, axis=-1)
            acc = acc * alpha[..., None] + jnp.einsum(
                "bhqk,bhkd->bhqd", p, vj,
                precision=jax.lax.Precision.HIGHEST)
            return (m_next, l_next, acc), None

        m0 = jnp.full((B, H, block_q), -jnp.inf, jnp.float32)
        l0 = jnp.zeros((B, H, block_q), jnp.float32)
        acc0 = jnp.zeros((B, H, block_q, D), jnp.float32)
        (m, l, acc), _ = jax.lax.scan(
            kv_tile_step, (m0, l0, acc0), (jnp.arange(Tk), k_tiles, v_tiles, bi)
        )
        l_safe = jnp.where(l == 0.0, 1.0, l)
        o = acc / l_safe[..., None]
        lse = m + jnp.log(l_safe)  # L = m + log(l): kernel_fp16.cu:541-542, in ln.
        return o, lse

    o_tiles, lse_tiles = jax.lax.map(
        lambda args: q_tile_step(args[0], (args[1], args[2])),
        (jnp.arange(Tq), q_tiles, b_tiles),
    )
    o = o_tiles.transpose(1, 2, 0, 3, 4).reshape(B, H, Nqp, D)[:, :, :Nq]
    lse = lse_tiles.transpose(1, 2, 0, 3).reshape(B, H, Nqp)[:, :, :Nq]
    return _FwdTiled(o.astype(q.dtype), lse)


def flash_attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
    return_lse: bool = False,
    window: tuple[int, int] | None = None,
):
    """Tiled online-softmax forward (golden model). `[B,H,N,D]` layout.

    Functionally identical to :func:`flashattn_tpu.ops.oracle.attention_reference`
    but computed tile-by-tile with running (m, l) statistics — the exact
    algorithm the Pallas kernels implement, so differences isolate kernel bugs
    from algorithm bugs.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv != H:
        k = jnp.repeat(k, H // Hkv, axis=1)
        v = jnp.repeat(v, H // Hkv, axis=1)
    out = _fwd_tiled(
        q, k, v,
        bias if bias is not None else jnp.zeros((), q.dtype),
        causal=causal, scale=float(scale),
        block_q=min(block_q, max(q.shape[2], 1)),
        block_k=min(block_k, max(k.shape[2], 1)),
        has_bias=bias is not None,
        window=window,
    )
    if return_lse:
        return out.o, out.lse
    return out.o


def flash_attention_reference_bwd(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    o: jax.Array,
    lse: jax.Array,
    do: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
):
    """Recompute-based backward (golden model), clean-spec scaling.

    Mirrors pure_torch_ver.py:125-152: ``D = rowsum(dO ⊙ O)``;
    ``P = exp(S - L)``; ``dV = Pᵀ dO``; ``dP = dO Vᵀ``; ``dS = P ∘ (dP − D)``;
    ``dQ = s · dS K``; ``dK = s · dSᵀ Q`` — with *symmetric* scale on dQ/dK
    (fixing reference quirk 1). Unfused (materializes S) — it is a spec, not a
    kernel; tiny shapes only.
    """
    B, H, Nq, Dh = q.shape
    Nk = k.shape[2]
    if scale is None:
        scale = float(Dh) ** -0.5
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    dof, of = do.astype(jnp.float32), o.astype(jnp.float32)

    s = jnp.einsum("bhqd,bhkd->bhqk", qf, kf,
                   precision=jax.lax.Precision.HIGHEST) * scale
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    if causal:
        mask = jnp.arange(Nk)[None, :] <= jnp.arange(Nq)[:, None]
        s = jnp.where(mask[None, None], s, DEFAULT_MASK_VALUE)
    p = jnp.exp(s - lse[..., None])

    d = jnp.sum(dof * of, axis=-1)  # [B,H,Nq] — one-shot preprocess (quirk 3 fix)
    dv = jnp.einsum("bhqk,bhqd->bhkd", p, dof,
                    precision=jax.lax.Precision.HIGHEST)
    dp = jnp.einsum("bhqd,bhkd->bhqk", dof, vf,
                    precision=jax.lax.Precision.HIGHEST)
    ds = p * (dp - d[..., None])
    dbias = ds if bias is not None else None
    dq = jnp.einsum("bhqk,bhkd->bhqd", ds, kf,
                    precision=jax.lax.Precision.HIGHEST) * scale
    dk = jnp.einsum("bhqk,bhqd->bhkd", ds, qf,
                    precision=jax.lax.Precision.HIGHEST) * scale
    out = (dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype))
    if bias is not None:
        return out + (dbias,)
    return out
