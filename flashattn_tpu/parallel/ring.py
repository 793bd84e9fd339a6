"""Ring attention: sequence-parallel fused attention over a device ring.

New scope vs the reference (it is single-GPU), but built from the reference's
own algebra: the stored per-row ``L = m + log(l)`` statistic
(kernel_fp16.cu:541-542) is exactly the merge primitive for combining partial
attention results across devices (SURVEY.md §5) —

    L = logaddexp(L1, L2);  O = e^{L1−L}·O1 + e^{L2−L}·O2.

Each device owns a contiguous sequence chunk of Q and of K/V. K/V chunks
rotate around the ring via ``jax.lax.ppermute`` (point-to-point; XLA
hands it to NCCL over NVLink);
each step computes a partial with the single-device kernel (passing
absolute position offsets so causal masks stay globally consistent) and
merges via the LSE rule. The backward pass rotates (K, V) together with
(dK, dV) accumulators — after a final rotation the accumulated gradients
arrive back at their home device — making sequence-parallel *training* work
end-to-end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flashattn_tpu.ops.flash import (
    _dispatch_dtype,
    _int_zero_cotangent,
    attention_bwd,
    attention_fwd,
)


def _perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _merge(o, lse, o_p, lse_p):
    """LSE-weighted merge of two normalized partials (f32)."""
    lse_new = jnp.logaddexp(lse, lse_p)
    w_old = jnp.exp(lse - lse_new)[..., None]
    w_new = jnp.exp(lse_p - lse_new)[..., None]
    return o * w_old + o_p * w_new, lse_new


def _partial_fwd(q, k_blk, v_blk, q_off, kv_off, *, causal, scale,
                 window=None, seg_q=None, seg_kv=None):
    offsets = jnp.stack([jnp.asarray(q_off, jnp.int32),
                         jnp.asarray(kv_off, jnp.int32)])
    o_p, lse_p = attention_fwd(
        q, k_blk, v_blk, offsets=offsets, scale=scale, causal=causal,
        window=window, seg_q=seg_q, seg_kv=seg_kv)
    return o_p.astype(jnp.float32), lse_p


def _chunk_grads(q, k_blk, v_blk, o, do, lse, q_off, kv_off, *,
                 causal, scale, window=None, seg_q=None, seg_kv=None):
    """Per-chunk-pair (dQ, dK, dV) via the single-device bwd kernels, with
    the *global* O and LSE so partial gradients sum exactly. GQA is handled
    inside the kernels (dK/dV come back at Hkv heads)."""
    offsets = jnp.stack([jnp.asarray(q_off, jnp.int32),
                         jnp.asarray(kv_off, jnp.int32)])
    dq, dk, dv, _ = attention_bwd(
        q, k_blk, v_blk, o, lse, do, offsets=offsets, scale=scale,
        causal=causal, window=window, seg_q=seg_q, seg_kv=seg_kv)
    return (dq.astype(jnp.float32), dk.astype(jnp.float32),
            dv.astype(jnp.float32))


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8, 9))
def _ring_core(q, k, v, seg_q, seg_kv, axis_name, n_dev, causal, scale,
               window):
    o, _ = _ring_fwd_loop(q, k, v, seg_q, seg_kv, axis_name, n_dev, causal,
                          scale, window)
    return o


def _ring_fwd_loop(q, k, v, seg_q, seg_kv, axis_name, n_dev, causal, scale,
                   window=None):
    B, H, nq, D = q.shape
    nk = k.shape[2]
    idx = jax.lax.axis_index(axis_name)
    q_off = idx * nq

    o = jnp.zeros((B, H, nq, D), jnp.float32)
    lse = jnp.full((B, H, nq), -jnp.inf, jnp.float32)
    k_blk, v_blk, skv_blk = k, v, seg_kv
    for step in range(n_dev):
        src = (idx - step) % n_dev
        kv_off = src * nk

        # Double-buffered rotation: issue the NEXT step's ppermute BEFORE
        # this step's attention kernel. The permute consumes the same
        # (k_blk, v_blk) the kernel reads, so the two are independent and
        # XLA's latency-hiding scheduler overlaps the transfer with the
        # per-tile compute (the north-star overlap clause; the distributed
        # analogue of the reference's online-softmax merge state,
        # kernel_fp16.cu:541-542).
        if step < n_dev - 1:
            k_next = jax.lax.ppermute(k_blk, axis_name, _perm(n_dev))
            v_next = jax.lax.ppermute(v_blk, axis_name, _perm(n_dev))
            skv_next = (jax.lax.ppermute(skv_blk, axis_name, _perm(n_dev))
                        if skv_blk is not None else None)

        def compute(o, lse, k_blk=k_blk, v_blk=v_blk, skv_blk=skv_blk,
                    kv_off=kv_off):
            o_p, lse_p = _partial_fwd(
                q, k_blk, v_blk, q_off, kv_off,
                causal=causal, scale=scale, window=window,
                seg_q=seg_q, seg_kv=skv_blk,
            )
            return _merge(o, lse, o_p, lse_p)

        needed = _chunk_needed(q_off, kv_off, nq, nk, causal, window)
        if needed is True:
            o, lse = compute(o, lse)
        else:
            # Chunks entirely outside the causal/window region: skip.
            o, lse = jax.lax.cond(
                needed, compute, lambda o, lse: (o, lse), o, lse
            )

        if step < n_dev - 1:
            k_blk, v_blk, skv_blk = k_next, v_next, skv_next
    return o.astype(q.dtype), lse


def _chunk_needed(q_off, kv_off, nq, nk, causal, window):
    """Whole-chunk skip predicate for the ring (conservative)."""
    wl, wr = window if window is not None else (-1, -1)
    needed = True
    if causal or wr >= 0:
        bound = q_off + nq - 1 + (wr if (wr >= 0 and not causal) else 0)
        needed = kv_off <= bound
    if wl >= 0:
        in_win = kv_off + nk - 1 >= q_off - wl
        needed = in_win if needed is True else jnp.logical_and(needed, in_win)
    return needed


def _ring_core_fwd(q, k, v, seg_q, seg_kv, axis_name, n_dev, causal, scale,
                   window):
    o, lse = _ring_fwd_loop(q, k, v, seg_q, seg_kv, axis_name, n_dev, causal,
                            scale, window)
    return o, (q, k, v, seg_q, seg_kv, o, lse)


def _ring_core_bwd(axis_name, n_dev, causal, scale, window, residuals, g):
    q, k, v, seg_q, seg_kv, o, lse = residuals
    B, H, nq, D = q.shape
    nk = k.shape[2]
    idx = jax.lax.axis_index(axis_name)
    q_off = idx * nq

    do = g.astype(q.dtype)
    dq = jnp.zeros((B, H, nq, D), jnp.float32)
    Hkv = k.shape[1]
    dk_acc = jnp.zeros((B, Hkv, nk, D), jnp.float32)
    dv_acc = jnp.zeros((B, Hkv, nk, D), jnp.float32)
    k_blk, v_blk, skv_blk = k, v, seg_kv
    for step in range(n_dev):
        src = (idx - step) % n_dev
        kv_off = src * nk

        def compute(dq, dk_acc, dv_acc, k_blk=k_blk, v_blk=v_blk,
                    skv_blk=skv_blk, kv_off=kv_off):
            dq_p, dk_p, dv_p = _chunk_grads(
                q, k_blk, v_blk, o, do, lse, q_off, kv_off,
                causal=causal, scale=scale, window=window,
                seg_q=seg_q, seg_kv=skv_blk,
            )
            return dq + dq_p, dk_acc + dk_p, dv_acc + dv_p

        # K/V for step s+1 rotate concurrently with step s's grad kernels
        # (same double-buffering as the forward loop).
        if step < n_dev - 1:
            k_next = jax.lax.ppermute(k_blk, axis_name, _perm(n_dev))
            v_next = jax.lax.ppermute(v_blk, axis_name, _perm(n_dev))
            skv_next = (jax.lax.ppermute(skv_blk, axis_name, _perm(n_dev))
                        if skv_blk is not None else None)

        needed = _chunk_needed(q_off, kv_off, nq, nk, causal, window)
        if needed is True:
            dq, dk_acc, dv_acc = compute(dq, dk_acc, dv_acc)
        else:
            dq, dk_acc, dv_acc = jax.lax.cond(
                needed, compute, lambda a, b, c: (a, b, c),
                dq, dk_acc, dv_acc,
            )

        if step < n_dev - 1:
            k_blk, v_blk, skv_blk = k_next, v_next, skv_next
        # accumulators travel with their chunk every step, including the
        # last: after this final rotation each (dK, dV) is home again.
        # (They rotate AFTER the compute that updates them — this permute
        # cannot overlap its own producer, but it overlaps the NEXT step's
        # kernels in the unrolled schedule.)
        dk_acc = jax.lax.ppermute(dk_acc, axis_name, _perm(n_dev))
        dv_acc = jax.lax.ppermute(dv_acc, axis_name, _perm(n_dev))

    def _seg_ct(s):
        return None if s is None else _int_zero_cotangent(s)

    return (dq.astype(q.dtype), dk_acc.astype(k.dtype),
            dv_acc.astype(v.dtype), _seg_ct(seg_q), _seg_ct(seg_kv))


_ring_core.defvjp(_ring_core_fwd, _ring_core_bwd)


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    axis_size: int,
    causal: bool = False,
    scale: float | None = None,
    window: tuple[int, int] | None = None,
    segment_ids: jax.Array | tuple | None = None,
) -> jax.Array:
    """Sequence-parallel fused attention (call *inside* ``shard_map``).

    q/k/v: local chunks ``[B, H, N/axis_size, D]``, sequence sharded on
    ``axis_name``. Differentiable (ring backward). GQA is supported by
    expanding KV heads to Q heads before the ring.

    ``segment_ids``: local id chunks for packed sequences — a single
    ``[B, N/axis_size]`` array (self-attention: q and kv chunks cover the
    same token range per device) or a ``(q_ids, kv_ids)`` tuple. The kv id
    chunk rotates around the ring alongside K/V (O(N) int32 per hop); dead
    partials merge as exact no-ops through the LSE rule (their stored LSE
    is ≈ LN2·mask_value, which ``logaddexp`` treats as −inf).
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    kdt = _dispatch_dtype(q.dtype)
    in_dtype = q.dtype
    if segment_ids is None:
        seg_q = seg_kv = None
    elif isinstance(segment_ids, (tuple, list)):
        seg_q, seg_kv = segment_ids
    else:
        seg_q = seg_kv = segment_ids
    # GQA: K/V stay at Hkv heads through the ring — every ppermute carries
    # only Hkv/Hq of the naive traffic; the kernels map q head h to kv head
    # h // rep, and the dK/dV kernel sums its GQA group in registers.
    o = _ring_core(
        q.astype(kdt), k.astype(kdt), v.astype(kdt), seg_q, seg_kv,
        axis_name, int(axis_size), bool(causal), float(scale),
        tuple(int(w) for w in window) if window is not None else None,
    )
    return o.astype(in_dtype)


def ring_attention_sharded(
    mesh: Mesh,
    *,
    axis: str = "seq",
    batch_axis: str | None = "data",
    head_axis: str | None = "model",
    causal: bool = False,
    scale: float | None = None,
    window: tuple[int, int] | None = None,
    with_segment_ids: bool = False,
):
    """Jitted global-shape entry point: shards sequence on ``axis`` (plus
    optional batch/head sharding) and runs :func:`ring_attention` on each
    shard — 2D/3D parallel attention (heads × sequence × data) in one call.

    With ``with_segment_ids=True`` the returned callable takes
    ``(q, k, v, segment_ids)``, ``segment_ids`` being the global ``[B, N]``
    int array (seq-sharded alongside the tensors)."""
    n = mesh.shape[axis]
    spec = P(batch_axis, head_axis, axis, None)

    if with_segment_ids:
        seg_spec = P(batch_axis, axis)

        def local_seg(q, k, v, seg):
            return ring_attention(
                q, k, v, axis_name=axis, axis_size=n, causal=causal,
                scale=scale, window=window, segment_ids=seg,
            )

        mapped = jax.shard_map(
            local_seg, mesh=mesh, in_specs=(spec, spec, spec, seg_spec),
            out_specs=spec,
            check_vma=False,  # pallas_call outputs carry no vma metadata
        )
        return jax.jit(mapped)

    def local(q, k, v):
        return ring_attention(
            q, k, v, axis_name=axis, axis_size=n, causal=causal, scale=scale,
            window=window,
        )

    mapped = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )
    return jax.jit(mapped)
