"""Zigzag ring attention: causally load-balanced sequence parallelism.

With contiguous sequence sharding, causal ring attention is maximally
imbalanced: device 0's rows attend one chunk while device P−1's attend all
P — every ring step runs at the busiest device's pace, so causal saves no
wall-clock. The zigzag layout splits the sequence into 2P chunks and gives
device d the PAIR (d, 2P−1−d): early rows and late rows together, so every
device owns the same causal area and each ring step does ~equal work
everywhere (the standard zigzag/striped CP layout used for long-context
LLM training).

Mechanics: the ring still rotates each device's (now two-chunk) KV block
with `ppermute`, but each step computes up to three sub-pair partials with
the single-device kernel (absolute offsets keep masks globally consistent):

  q_hi × k_lo : always live (late rows attend early columns) — and fully
                unmasked except on the diagonal pairing;
  q_lo × k_lo : live iff src ≤ d   (diagonal when src == d);
  q_hi × k_hi : live iff src ≥ d   (diagonal when src == d);
  q_lo × k_hi : never live (early rows, late columns) — statically absent.

Per step that is ~2 quarter-chunk pairs on every device — exactly the 50%
causal work, balanced, instead of plain ring's 1..P spread. Partials merge
with the same L = m + log l algebra the reference stores residuals for
(kernel_fp16.cu:541-542); the backward rotates (dK, dV) accumulators with
their chunks like the plain ring (ring.py).

The layout contract: local chunks are ``[chunk_d ; chunk_{2P-1-d}]`` along
the sequence axis. `zigzag_shard` / `zigzag_unshard` convert a gathered
global array to/from this order; `zigzag_ring_attention_sharded` applies
them around the shard_map so callers keep natural token order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from flashattn_tpu.ops.flash import _dispatch_dtype
from flashattn_tpu.parallel.ring import (
    _chunk_grads,
    _merge,
    _partial_fwd,
    _perm,
)


def zigzag_order(n_total: int, n_dev: int) -> np.ndarray:
    """Global row permutation: natural order → zigzag-sharded order.

    Row i of the permuted array is row ``order[i]`` of the natural array;
    device d's contiguous shard of the permuted array holds natural chunks
    (d, 2P−1−d).
    """
    c, rem = divmod(n_total, 2 * n_dev)
    if rem or c == 0:
        raise ValueError(
            f"zigzag needs the sequence ({n_total}) divisible into "
            f"2*devices={2 * n_dev} equal chunks")
    order = np.empty(n_total, np.int64)
    pos = 0
    for d in range(n_dev):
        order[pos:pos + c] = np.arange(d * c, (d + 1) * c)
        order[pos + c:pos + 2 * c] = np.arange(
            (2 * n_dev - 1 - d) * c, (2 * n_dev - d) * c)
        pos += 2 * c
    return order


def zigzag_shard(x: jax.Array, n_dev: int, axis: int = 2) -> jax.Array:
    """Permute a (global) array's sequence axis into zigzag order."""
    return jnp.take(x, zigzag_order(x.shape[axis], n_dev), axis=axis)


def zigzag_unshard(x: jax.Array, n_dev: int, axis: int = 2) -> jax.Array:
    """Inverse of :func:`zigzag_shard`."""
    order = zigzag_order(x.shape[axis], n_dev)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return jnp.take(x, inv, axis=axis)


def _offsets(idx, c, n_dev):
    """Global row offsets of a device's (lo, hi) chunks."""
    return idx * c, (2 * n_dev - 1 - idx) * c


def _zz_fwd_loop(q, k, v, axis_name, n_dev, scale):
    B, H, n2c, D = q.shape
    c = n2c // 2
    idx = jax.lax.axis_index(axis_name)
    q_lo_off, q_hi_off = _offsets(idx, c, n_dev)
    q_lo, q_hi = q[:, :, :c], q[:, :, c:]

    o_lo = jnp.zeros((B, H, c, D), jnp.float32)
    o_hi = jnp.zeros((B, H, c, D), jnp.float32)
    lse_lo = jnp.full((B, H, c), -jnp.inf, jnp.float32)
    lse_hi = jnp.full((B, H, c), -jnp.inf, jnp.float32)

    k_blk, v_blk = k, v
    for step in range(n_dev):
        src = (idx - step) % n_dev
        if step < n_dev - 1:
            k_next = jax.lax.ppermute(k_blk, axis_name, _perm(n_dev))
            v_next = jax.lax.ppermute(v_blk, axis_name, _perm(n_dev))
        k_lo_off, k_hi_off = _offsets(src, c, n_dev)
        k_lo, k_hi = k_blk[:, :, :c], k_blk[:, :, c:]
        v_lo, v_hi = v_blk[:, :, :c], v_blk[:, :, c:]

        # q_hi × k_lo: live at every step on every device (the balance).
        o_p, lse_p = _partial_fwd(
            q_hi, k_lo, v_lo, q_hi_off, k_lo_off,
            causal=True, scale=scale)
        o_hi, lse_hi = _merge(o_hi, lse_hi, o_p, lse_p)

        def lo_lo(o_lo, lse_lo, k_lo=k_lo, v_lo=v_lo, k_lo_off=k_lo_off):
            o_p, lse_p = _partial_fwd(
                q_lo, k_lo, v_lo, q_lo_off, k_lo_off,
                causal=True, scale=scale)
            return _merge(o_lo, lse_lo, o_p, lse_p)

        o_lo, lse_lo = jax.lax.cond(
            src <= idx, lo_lo, lambda o, l: (o, l), o_lo, lse_lo)

        def hi_hi(o_hi, lse_hi, k_hi=k_hi, v_hi=v_hi, k_hi_off=k_hi_off):
            o_p, lse_p = _partial_fwd(
                q_hi, k_hi, v_hi, q_hi_off, k_hi_off,
                causal=True, scale=scale)
            return _merge(o_hi, lse_hi, o_p, lse_p)

        o_hi, lse_hi = jax.lax.cond(
            src >= idx, hi_hi, lambda o, l: (o, l), o_hi, lse_hi)

        if step < n_dev - 1:
            k_blk, v_blk = k_next, v_next

    o = jnp.concatenate([o_lo, o_hi], axis=2).astype(q.dtype)
    lse = jnp.concatenate([lse_lo, lse_hi], axis=2)
    return o, lse


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def _zz_core(q, k, v, axis_name, n_dev, scale):
    return _zz_fwd_loop(q, k, v, axis_name, n_dev, scale)[0]


def _zz_core_fwd(q, k, v, axis_name, n_dev, scale):
    o, lse = _zz_fwd_loop(q, k, v, axis_name, n_dev, scale)
    return o, (q, k, v, o, lse)


def _zz_core_bwd(axis_name, n_dev, scale, residuals, g):
    q, k, v, o, lse = residuals
    B, H, n2c, D = q.shape
    c = n2c // 2
    Hkv = k.shape[1]
    idx = jax.lax.axis_index(axis_name)
    q_lo_off, q_hi_off = _offsets(idx, c, n_dev)

    do = g.astype(q.dtype)
    q_lo, q_hi = q[:, :, :c], q[:, :, c:]
    do_lo, do_hi = do[:, :, :c], do[:, :, c:]
    o_lo, o_hi = o[:, :, :c], o[:, :, c:]
    lse_lo, lse_hi = lse[:, :, :c], lse[:, :, c:]

    dq_lo = jnp.zeros((B, H, c, D), jnp.float32)
    dq_hi = jnp.zeros((B, H, c, D), jnp.float32)
    dk_acc = jnp.zeros((B, Hkv, n2c, D), jnp.float32)
    dv_acc = jnp.zeros((B, Hkv, n2c, D), jnp.float32)

    k_blk, v_blk = k, v
    for step in range(n_dev):
        src = (idx - step) % n_dev
        if step < n_dev - 1:
            k_next = jax.lax.ppermute(k_blk, axis_name, _perm(n_dev))
            v_next = jax.lax.ppermute(v_blk, axis_name, _perm(n_dev))
        k_lo_off, k_hi_off = _offsets(src, c, n_dev)
        k_lo, k_hi = k_blk[:, :, :c], k_blk[:, :, c:]
        v_lo, v_hi = v_blk[:, :, :c], v_blk[:, :, c:]

        # q_hi × k_lo (always live)
        dq_p, dk_p, dv_p = _chunk_grads(
            q_hi, k_lo, v_lo, o_hi, do_hi, lse_hi, q_hi_off, k_lo_off,
            causal=True, scale=scale)
        dq_hi = dq_hi + dq_p
        dk_acc = dk_acc.at[:, :, :c].add(dk_p)
        dv_acc = dv_acc.at[:, :, :c].add(dv_p)

        def lo_lo(dq_lo, dk_acc, dv_acc, k_lo=k_lo, v_lo=v_lo,
                  k_lo_off=k_lo_off):
            dq_p, dk_p, dv_p = _chunk_grads(
                q_lo, k_lo, v_lo, o_lo, do_lo, lse_lo, q_lo_off, k_lo_off,
                causal=True, scale=scale)
            return (dq_lo + dq_p, dk_acc.at[:, :, :c].add(dk_p),
                    dv_acc.at[:, :, :c].add(dv_p))

        dq_lo, dk_acc, dv_acc = jax.lax.cond(
            src <= idx, lo_lo, lambda a, b, cc: (a, b, cc),
            dq_lo, dk_acc, dv_acc)

        def hi_hi(dq_hi, dk_acc, dv_acc, k_hi=k_hi, v_hi=v_hi,
                  k_hi_off=k_hi_off):
            dq_p, dk_p, dv_p = _chunk_grads(
                q_hi, k_hi, v_hi, o_hi, do_hi, lse_hi, q_hi_off, k_hi_off,
                causal=True, scale=scale)
            return (dq_hi + dq_p, dk_acc.at[:, :, c:].add(dk_p),
                    dv_acc.at[:, :, c:].add(dv_p))

        dq_hi, dk_acc, dv_acc = jax.lax.cond(
            src >= idx, hi_hi, lambda a, b, cc: (a, b, cc),
            dq_hi, dk_acc, dv_acc)

        if step < n_dev - 1:
            k_blk, v_blk = k_next, v_next
        # accumulators travel home with their chunks (n_dev rotations total)
        dk_acc = jax.lax.ppermute(dk_acc, axis_name, _perm(n_dev))
        dv_acc = jax.lax.ppermute(dv_acc, axis_name, _perm(n_dev))

    dq = jnp.concatenate([dq_lo, dq_hi], axis=2)
    return dq.astype(q.dtype), dk_acc.astype(k.dtype), dv_acc.astype(v.dtype)


_zz_core.defvjp(_zz_core_fwd, _zz_core_bwd)


def zigzag_ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    axis_size: int,
    scale: float | None = None,
) -> jax.Array:
    """Causal ring attention on ZIGZAG-layout local chunks (inside
    ``shard_map``): q/k/v are ``[B, H(,kv), 2c, D]`` holding natural chunks
    ``(d, 2P−1−d)`` concatenated. Differentiable; GQA supported (KV rotates
    at Hkv heads). Causal-only — for non-causal or windowed attention the
    plain ring (ring.py) is already balanced.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.shape[2] % 2:
        raise ValueError("zigzag local chunks hold two sub-chunks; local "
                         f"sequence length must be even, got {q.shape[2]}")
    kdt = _dispatch_dtype(q.dtype)
    in_dtype = q.dtype
    o = _zz_core(
        q.astype(kdt), k.astype(kdt), v.astype(kdt),
        axis_name, int(axis_size), float(scale),
    )
    return o.astype(in_dtype)


def zigzag_ring_attention_sharded(
    mesh: Mesh,
    *,
    axis: str = "seq",
    batch_axis: str | None = "data",
    head_axis: str | None = "model",
    scale: float | None = None,
):
    """Jitted global-shape entry point: accepts NATURAL token order,
    permutes to the zigzag layout (one gather each way, sharded by XLA),
    and runs the balanced causal ring."""
    n = mesh.shape[axis]
    spec = P(batch_axis, head_axis, axis, None)

    def local(q, k, v):
        return zigzag_ring_attention(
            q, k, v, axis_name=axis, axis_size=n, scale=scale)

    mapped = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )

    def run(q, k, v):
        qz = zigzag_shard(q, n)
        kz = zigzag_shard(k, n)
        vz = zigzag_shard(v, n)
        return zigzag_unshard(mapped(qz, kz, vz), n)

    return jax.jit(run)
