"""Public fused-attention API: layouts, validation, tile policy, autograd.

The host stack around the Hopper kernels (:mod:`flashattn_tpu.ops.flash_fwd`,
:mod:`flashattn_tpu.ops.flash_bwd`), in the role of the reference's
FlashAttn.py / host.cpp:

  * tile policy — FlashAttn.py:56-67's Br/Bc choice → :class:`BlockSizes`
    and :func:`choose_block_sizes`, a table keyed by head-dim class;
  * padding — the kernels' wrappers pad sequence axes to the tile and the
    head dim to a power of two, under jit, and slice the result;
  * dtypes — bf16, fp16 and f32 all run natively (fp16 on the tensor cores
    at the bf16 rate; f32 products as six bf16 passes, f32-class);
  * autograd — FlashAttn.py:45-92's ``torch.autograd.Function`` →
    ``jax.custom_vjp`` saving (q, k, v, bias, O, L);
  * layouts — the reference's ``permute_NH`` stride swap → "BHND" and
    "BNHD" both accepted.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from flashattn_tpu.ops import flash_bwd, flash_fwd


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Kernel tile sizes (the Br/Bc policy surface, FlashAttn.py:56-67):
    the forward's (block_q, block_k), the dK/dV kernel's and the dQ
    kernel's. Each is a power of two >= 16 (Triton tiles and the
    tensor-core dot's minimum side). A dK/dV Q step that computed wrong
    values on the card is refused when the tiles meet a head dim
    (``flash_fwd.DKV_REFUSED_BLOCK_Q``)."""

    block_q: int = 128
    block_k: int = 64
    block_q_dkv: int = 64
    block_k_dkv: int = 64
    block_q_dq: int = 128
    block_k_dq: int = 32

    def __post_init__(self):
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if val < flash_fwd.MIN_BLOCK or val & (val - 1):
                raise ValueError(
                    f"{f.name}={val} must be a power of two >= "
                    f"{flash_fwd.MIN_BLOCK}")


def choose_block_sizes(nq: int, nk: int, d: int) -> BlockSizes:
    """Default tiles: the Hopper launch table for the head-dim class,
    shrunk to the sequence so short inputs (decode's single query) do not
    pad to a full tile."""
    cls = flash_fwd.head_dim_class(d)
    fwd = flash_fwd._FWD_TABLE[cls]
    dkv = flash_fwd._DKV_TABLE[cls]
    dq = flash_fwd._DQ_TABLE[cls]
    fit = flash_fwd.fit_block
    return BlockSizes(
        block_q=fit(fwd.block_q, nq), block_k=fit(fwd.block_k, nk),
        block_q_dkv=flash_fwd.fit_dkv_block_q(dkv.block_q, nq, cls),
        block_k_dkv=fit(dkv.block_k, nk),
        block_q_dq=fit(dq.block_q, nq), block_k_dq=fit(dq.block_k, nk))


def _kernel_configs(blocks: BlockSizes, d: int):
    """(fwd, dkv, dq) launch configs: the tiles of ``blocks`` with the
    table's warp and stage counts for the head-dim class."""
    cls = flash_fwd.head_dim_class(d)

    def cfg(table, bq, bk):
        t = table[cls]
        return flash_fwd.KernelConfig(bq, bk, t.num_warps, t.num_stages)

    dkv = cfg(flash_fwd._DKV_TABLE, blocks.block_q_dkv, blocks.block_k_dkv)
    flash_fwd.check_dkv_config(dkv, cls)
    return (cfg(flash_fwd._FWD_TABLE, blocks.block_q, blocks.block_k), dkv,
            cfg(flash_fwd._DQ_TABLE, blocks.block_q_dq, blocks.block_k_dq))


def explain_plan(q_shape, k_shape, dtype=jnp.bfloat16, causal=False) -> dict:
    """Launch plan for an attention call — the diagnostic role of the
    reference's failure printfs (shapes/grid/LDS on error,
    kernel_fp16.cu:854-863), exposed proactively: tiles, padded shapes,
    grids, warps/stages and the forward's matmul FLOPs."""
    B, Hq, Nq, D = q_shape
    Hkv, Nk = k_shape[1], k_shape[2]
    del dtype
    bs = choose_block_sizes(Nq, Nk, D)
    fwd, dkv, dq = _kernel_configs(bs, D)
    info = {"B": B, "H": Hq, "Hkv": Hkv, "Nq": Nq, "Nk": Nk, "D": D,
            "causal": causal, **dataclasses.asdict(bs)}
    info["d_padded"] = flash_fwd.pad_head_dim(D)
    info["nq_padded"] = flash_fwd.round_up(Nq, bs.block_q)
    info["nk_padded"] = flash_fwd.round_up(Nk, bs.block_k)
    info["fwd_grid"] = (info["nq_padded"] // bs.block_q, B, Hq)
    info["dkv_grid"] = (flash_fwd.round_up(Nk, bs.block_k_dkv)
                        // bs.block_k_dkv, B, Hkv)
    info["dq_grid"] = (flash_fwd.round_up(Nq, bs.block_q_dq)
                       // bs.block_q_dq, B, Hq)
    for name, c in (("fwd", fwd), ("dkv", dkv), ("dq", dq)):
        info[f"{name}_warps_stages"] = (c.num_warps, c.num_stages)
    pairs = Nq * Nk / 2 if causal else Nq * Nk
    info["fwd_flops"] = int(4 * B * Hq * D * pairs)
    return info


def _dispatch_dtype(dtype) -> jnp.dtype:
    """Kernel dtype per input dtype (host.cpp:30-45's role): bf16, fp16 and
    f32 run natively; anything else runs in f32."""
    dtype = jnp.dtype(dtype)
    if dtype in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16),
                 jnp.dtype(jnp.float32)):
        return dtype
    return jnp.dtype(jnp.float32)


def _to_bhnd(x, layout):
    if x is None:
        return None
    if layout == "BHND":
        return x
    if layout == "BNHD":
        return jnp.swapaxes(x, 1, 2)
    raise ValueError(f"unknown layout {layout!r} (expected 'BHND' or 'BNHD')")


def _from_bhnd(x, layout):
    return x if layout == "BHND" else jnp.swapaxes(x, 1, 2)


def _int_zero_cotangent(x):
    """Cotangent for integer leaves (offsets, segment ids): float0 zeros."""
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


def attention_fwd(q, k, v, *, offsets, scale, causal, blocks=None,
                  window=None, softcap=None, bias=None, seg_q=None,
                  seg_kv=None, k_scale=None, v_scale=None, return_lse=True,
                  interpret=None):
    """Forward kernel on canonical ``[B, H, N, D]`` inputs → ``(o, lse)``.
    The building block of the autograd core and of the ring layers."""
    if blocks is None:
        blocks = choose_block_sizes(q.shape[2], k.shape[2], q.shape[3])
    fwd_cfg = _kernel_configs(blocks, q.shape[3])[0]
    return flash_fwd.fwd(
        q, k, v, offsets=offsets, scale=scale, causal=causal, window=window,
        softcap=softcap, bias=bias, seg_q=seg_q, seg_kv=seg_kv,
        k_scale=k_scale, v_scale=v_scale, return_lse=return_lse,
        config=fwd_cfg, interpret=interpret)


def attention_bwd(q, k, v, o, lse, do, *, offsets, scale, causal,
                  blocks=None, window=None, softcap=None, bias=None,
                  seg_q=None, seg_kv=None, interpret=None):
    """Backward kernels → ``(dq, dk, dv, dbias)``; see
    :func:`flash_bwd.bwd`."""
    if blocks is None:
        blocks = choose_block_sizes(q.shape[2], k.shape[2], q.shape[3])
    _, dkv_cfg, dq_cfg = _kernel_configs(blocks, q.shape[3])
    return flash_bwd.bwd(
        q, k, v, o, lse, do, offsets=offsets, scale=scale, causal=causal,
        window=window, softcap=softcap, bias=bias, seg_q=seg_q,
        seg_kv=seg_kv, dkv_config=dkv_cfg, dq_config=dq_cfg,
        interpret=interpret)


# ─────────────────────────── custom_vjp core ────────────────────────────────
# Differentiable in (q, k, v, bias); offsets and segment ids are integer
# leaves with float0 cotangents; the rest is static.


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8, 9, 10, 11, 12))
def _flash_core(q, k, v, bias, offsets, seg_q, seg_kv, scale, causal, blocks,
                interpret, window, softcap):
    return attention_fwd(
        q, k, v, offsets=offsets, scale=scale, causal=causal, blocks=blocks,
        window=window, softcap=softcap, bias=bias, seg_q=seg_q,
        seg_kv=seg_kv, return_lse=False, interpret=interpret)[0]


def _flash_core_fwd(q, k, v, bias, offsets, seg_q, seg_kv, scale, causal,
                    blocks, interpret, window, softcap):
    o, lse = attention_fwd(
        q, k, v, offsets=offsets, scale=scale, causal=causal, blocks=blocks,
        window=window, softcap=softcap, bias=bias, seg_q=seg_q,
        seg_kv=seg_kv, return_lse=True, interpret=interpret)
    return o, (q, k, v, bias, offsets, seg_q, seg_kv, o, lse)


def _flash_core_bwd(scale, causal, blocks, interpret, window, softcap,
                    residuals, g):
    q, k, v, bias, offsets, seg_q, seg_kv, o, lse = residuals
    dq, dk, dv, dbias = attention_bwd(
        q, k, v, o, lse, g, offsets=offsets, scale=scale, causal=causal,
        blocks=blocks, window=window, softcap=softcap, bias=bias,
        seg_q=seg_q, seg_kv=seg_kv, interpret=interpret)
    if bias is not None:
        # Reduce over the bias's broadcast dims back to its own shape.
        axes = tuple(a for a in (0, 1, 2) if bias.shape[a] == 1)
        dbias = dbias.sum(axis=axes, keepdims=True).astype(bias.dtype)

    def int_ct(x):
        return None if x is None else _int_zero_cotangent(x)

    return (dq, dk, dv, dbias, int_ct(offsets), int_ct(seg_q),
            int_ct(seg_kv))


_flash_core.defvjp(_flash_core_fwd, _flash_core_bwd)


# ───────────────────────────── public API ───────────────────────────────────


def _prepare(q, k, v, bias, layout, scale, q_offset, kv_offset, window,
             segment_ids, logit_softcap):
    """Shared argument handling of the public entry points."""
    q, k, v = (_to_bhnd(x, layout) for x in (q, k, v))
    _validate(q, k, v, bias)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    kdt = _dispatch_dtype(q.dtype)
    q, k, v = q.astype(kdt), k.astype(kdt), v.astype(kdt)
    offsets = jnp.stack([jnp.asarray(q_offset, jnp.int32),
                         jnp.asarray(kv_offset, jnp.int32)])
    seg_q, seg_kv = _normalize_segment_ids(segment_ids, q, k)
    window = tuple(int(w) for w in window) if window is not None else None
    softcap = float(logit_softcap) if logit_softcap is not None else None
    return q, k, v, float(scale), offsets, seg_q, seg_kv, window, softcap


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
    block_sizes: BlockSizes | None = None,
    q_offset: jax.Array | int = 0,
    kv_offset: jax.Array | int = 0,
    window: tuple[int, int] | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Fused FlashAttention-2, differentiable, arbitrary shapes.

    Args:
      q/k/v: ``[B, H, N, D]`` (layout="BHND") or ``[B, N, H, D]``
        (layout="BNHD" — the reference's ``BNHD_fmt``/``permute_NH`` path,
        FlashAttn.py:59-61). K/V may have fewer heads (GQA) as long as they
        divide Q's head count. ``Nk`` may differ from ``Nq``. bf16, fp16 and
        f32 run natively; f32 products are f32-class (six bf16 passes, not
        TF32).
      bias: additive attention bias (real support — the reference's ``mask``
        arg is dead, FlashAttn.py:49), shape broadcastable to
        ``[B, H, Nq, Nk]`` over batch/head/query (dims of size 1);
        differentiable.
      causal: causal masking; tiles above the diagonal are never visited.
      scale: softmax scale, default ``D ** -0.5`` (FlashAttn.py:63-64).
      q_offset/kv_offset: absolute position offsets of the q/kv chunks (for
        sequence-parallel callers); ints or scalar int32 arrays.
      window: optional sliding window ``(left, right)``: absolute position
        pair (i, j) attends iff ``i - left <= j <= i + right``; -1 disables a
        side (Mistral-style local attention is ``window=(w-1, 0)`` or
        ``causal=True, window=(w-1, -1)``). Tiles outside the band are never
        visited, so cost scales with the window, not N².
      segment_ids: packed-sequence (varlen) masking — pair (i, j) attends iff
        ``seg_q[i] == seg_kv[j]`` (AND-composed with causal/window). Either a
        single ``[B, N]`` int array (self-attention, Nq == Nk) or a tuple
        ``(q_ids [B, Nq], kv_ids [B, Nk])``. Ids must be >= 0 (negatives are
        reserved padding sentinels); a q row whose id matches no kv token
        outputs zeros and receives zero gradients.
      logit_softcap: Gemma-2-style logit soft-capping: the scaled logits
        pass through ``cap·tanh(s/cap)`` before bias/mask/softmax (and the
        backward chains the ``1 − tanh²`` Jacobian). Differentiable;
        composes with causal/window/segments/bias/GQA.
      block_sizes: override the tile policy.
      interpret: run the Pallas kernels in interpreter mode (None = the
        backend's rule: compile on the GPU, interpret on the CPU).
    Returns:
      Attention output, same shape/layout/dtype as ``q``.
    """
    in_dtype = q.dtype
    qc, k, v, scale, offsets, seg_q, seg_kv, window, softcap = _prepare(
        q, k, v, bias, layout, scale, q_offset, kv_offset, window,
        segment_ids, logit_softcap)

    # GQA decode fold: tiny-Nq queries against a GQA cache would read each
    # KV tile rep = Hq/Hkv times (one program per q head). Folding one kv
    # head's rep q-heads into the Q-tile ROWS reads the cache once:
    # [B, Hq, Nq, D] -> [B, Hkv, rep·Nq, D] — head-major rows, the kernel's
    # h // rep GQA mapping, within one 16/32-row tile. Sound only when no
    # mask depends on a row's position: non-causal, no window/segments, and
    # a bias without a head dim (decode's cache-slot mask).
    rep_fold = qc.shape[1] // k.shape[1]
    if (rep_fold > 1 and not causal and window is None
            and (bias is None or bias.shape[1] == 1)
            and segment_ids is None and qc.shape[2] * rep_fold <= 32
            and block_sizes is None):
        B_, Hq_, Nq_, D_ = qc.shape
        bf = bias
        if bf is not None and bf.shape[2] > 1:
            bf = jnp.tile(bf, (1, 1, rep_fold, 1))
        of = flash_attention(
            qc.reshape(B_, k.shape[1], rep_fold * Nq_, D_), k, v, bias=bf,
            scale=scale, logit_softcap=logit_softcap, interpret=interpret)
        return _from_bhnd(
            of.reshape(B_, Hq_, Nq_, D_).astype(in_dtype), layout)

    if block_sizes is None:
        block_sizes = choose_block_sizes(qc.shape[2], k.shape[2],
                                         qc.shape[3])
    o = _flash_core(qc, k, v, bias, offsets, seg_q, seg_kv, scale,
                    bool(causal), block_sizes, interpret, window, softcap)
    return _from_bhnd(o.astype(in_dtype), layout)


def _normalize_segment_ids(segment_ids, q, k):
    """Validate/split the public ``segment_ids`` arg into (q_ids, kv_ids)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        seg_q, seg_kv = segment_ids
    else:
        if q.shape[2] != k.shape[2]:
            raise ValueError(
                "a single segment_ids array requires Nq == Nk; pass a "
                f"(q_ids, kv_ids) tuple for Nq={q.shape[2]} Nk={k.shape[2]}")
        seg_q = seg_kv = segment_ids
    if not jnp.issubdtype(seg_q.dtype, jnp.integer):
        raise ValueError(f"segment ids must be integers, got {seg_q.dtype}")
    B, _, Nq, _ = q.shape
    Nk = k.shape[2]
    if seg_q.shape != (B, Nq) or seg_kv.shape != (B, Nk):
        raise ValueError(
            f"segment id shapes {seg_q.shape}/{seg_kv.shape} must be "
            f"({B}, {Nq}) / ({B}, {Nk})")
    return seg_q, seg_kv


def flash_attention_with_lse(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    bias: jax.Array | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
    block_sizes: BlockSizes | None = None,
    q_offset: jax.Array | int = 0,
    kv_offset: jax.Array | int = 0,
    window: tuple[int, int] | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Forward-only fused attention returning ``(O, L)`` with
    ``L = logsumexp`` per row ``[B, H, Nq]`` — the merge primitive for ring
    attention / sequence-parallel partial combines (SURVEY.md §5).
    """
    in_dtype = q.dtype
    q, k, v, scale, offsets, seg_q, seg_kv, window, softcap = _prepare(
        q, k, v, bias, layout, scale, q_offset, kv_offset, window,
        segment_ids, logit_softcap)
    o, lse = attention_fwd(
        q, k, v, offsets=offsets, scale=scale, causal=bool(causal),
        blocks=block_sizes, window=window, softcap=softcap, bias=bias,
        seg_q=seg_q, seg_kv=seg_kv, return_lse=True, interpret=interpret)
    return _from_bhnd(o.astype(in_dtype), layout), lse


def _validate(q, k, v, bias):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4, got {q.shape}, {k.shape}, {v.shape}"
        )
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {k.shape} vs {v.shape}")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {k.shape} incompatible with q {q.shape}")
    if Hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={k.shape[1]}")
    if bias is not None:
        if bias.ndim != 4:
            raise ValueError(f"bias must be rank-4, got {bias.shape}")
        Bb, Hb, Nqb, Nkb = bias.shape
        if Bb not in (1, B) or Hb not in (1, Hq):
            raise ValueError(f"bias batch/head {bias.shape} not broadcastable")
        if Nqb not in (1, Nq) or Nkb != k.shape[2]:
            raise ValueError(
                f"bias seq dims {bias.shape} must be (1|{Nq}, {k.shape[2]})"
            )
