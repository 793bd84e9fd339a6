"""FlashAttention-2 backward kernels for Hopper (Pallas, Triton route).

The FA-2 split, with no atomics and no cross-program sum:

  * ``flash_dkv`` — one program per (KV tile, batch, kv head). It keeps its
    K/V tile and the f32 dK/dV accumulators in registers and loops over the
    q heads of its GQA group and over the Q tiles that can see the tile, so
    GQA needs no reduction afterwards.
  * ``flash_dq`` — one program per (Q tile, batch, q head), looping over the
    KV tiles that the tile can see. It also writes the bias gradient
    (zeros for tiles it skips).

Both recompute ``P = exp(S − L)`` from the forward's row log-sum-exp ``L``
and use ``Δ = rowsum(dO ⊙ O)`` computed once by XLA; dQ and dK carry the
softmax scale. With logit soft-capping the score gradient is chained through
``1 − tanh²``; the bias gradient is the gradient of the capped logits.
Loop bounds and edge masks follow :mod:`flashattn_tpu.ops.flash_fwd`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from flashattn_tpu.ops import flash_fwd as ff
from flashattn_tpu.ops.flash_fwd import LOG2E
from flashattn_tpu.utils import platform


def q_block_range(c0, d, *, block_q, block_k, causal, window, kv_len, q_len,
                  mask_all):
    """Q-tile ranges for the KV columns ``[c0, c0 + block_k)`` — the
    transpose of :func:`flash_fwd.kv_block_range`. Returns
    ``(lo, full_lo, full_hi, hi)`` over Q tiles."""
    wl, wr = window if window is not None else (-1, -1)
    nqb = ff.round_up(q_len, block_q) // block_q
    lo = jnp.int32(0)
    full_lo = jnp.int32(0)
    if causal:
        lo = ff._div(jnp.maximum(c0 - d, 0), block_q)
        full_lo = ff._cdiv(jnp.maximum(c0 + block_k - 1 - d, 0), block_q)
    elif wr >= 0:
        lo = ff._div(jnp.maximum(c0 - d - wr, 0), block_q)
        full_lo = ff._cdiv(jnp.maximum(c0 + block_k - 1 - d - wr, 0),
                           block_q)
    hi = jnp.int32(nqb)
    full_hi = jnp.int32(q_len // block_q)
    if wl >= 0:
        hi = jnp.minimum(hi, ff._cdiv(jnp.maximum(c0 + block_k - d + wl, 0),
                                      block_q))
        full_hi = jnp.minimum(
            full_hi, ff._div(jnp.maximum(c0 + 1 - d + wl, 0), block_q))
    # A tile wholly past the valid KV length contributes nothing; one that
    # straddles it is an edge tile throughout.
    hi = jnp.where(c0 >= kv_len, lo, hi)
    lo = jnp.minimum(lo, hi)
    if mask_all:
        return lo, hi, hi, hi
    full_lo = jnp.where(c0 + block_k > kv_len, hi, full_lo)
    full_lo = jnp.clip(full_lo, lo, hi)
    full_hi = jnp.clip(full_hi, full_lo, hi)
    return lo, full_lo, full_hi, hi


def _scores(q, k, *, scale, softcap, bias, prec):
    """Natural-log scores of a tile and the soft-cap Jacobian (or None)."""
    s = pl.dot(q, k, trans_b=True, precision=prec)
    jac = None
    if softcap is not None:
        t = jnp.tanh(s * (scale / softcap))
        jac = 1.0 - t * t
        s = softcap * t
    else:
        s = s * scale
    if bias is not None:
        s = s + bias.astype(jnp.float32)
    return s, jac


def _dkv_kernel(refs, *, scale, causal, window, softcap, kv_len, q_len,
                block_q, block_k, rep, bias_rows, bias_heads):
    k_ref, v_ref = refs["k"], refs["v"]
    q_ref, do_ref = refs["q"], refs["do"]
    lse_ref, delta_ref = refs["lse"], refs["delta"]
    bias_ref = refs.get("bias")
    sq_ref, skv_ref = refs.get("seg_q"), refs.get("seg_kv")
    j = pl.program_id(0)
    c0 = j * block_k
    d = refs["offs"][0] - refs["offs"][1]
    k = k_ref[...]
    v = v_ref[...]
    cdt = k.dtype
    prec = ff.dot_precision(cdt)
    col_idx = c0 + jnp.arange(block_k, dtype=jnp.int32)
    seg_kv = skv_ref[...] if skv_ref is not None else None
    ranges = q_block_range(c0, d, block_q=block_q, block_k=block_k,
                           causal=causal, window=window, kv_len=kv_len,
                           q_len=q_len, mask_all=seg_kv is not None)

    def head(r, carry):
        def body(t, carry, masked):
            dk, dv = carry
            r0 = t * block_q
            rows = pl.ds(r0, block_q)
            q = q_ref[r, rows, :]
            do = do_ref[r, rows, :]
            bias = None
            if bias_ref is not None:
                hb = r if bias_heads > 1 else 0
                bias = (bias_ref[hb, 0, :][None, :] if bias_rows == 1
                        else bias_ref[hb, rows, :])
            s, jac = _scores(q, k, scale=scale, softcap=softcap, bias=bias,
                             prec=prec)
            p = jnp.exp2(s * LOG2E - (lse_ref[r, rows] * LOG2E)[:, None])
            if masked:
                row_idx = r0 + jnp.arange(block_q, dtype=jnp.int32)
                mask = ff.pair_mask(
                    row_idx, col_idx, d, causal=causal, window=window,
                    kv_len=kv_len, seg_kv=seg_kv,
                    seg_q=sq_ref[rows] if seg_kv is not None else None)
                p = jnp.where(mask, p, 0.0)
            dv = dv + pl.dot(p.astype(cdt), do, trans_a=True, precision=prec)
            dp = pl.dot(do, v, trans_b=True, precision=prec)
            ds = p * (dp - delta_ref[r, rows][:, None])
            if jac is not None:
                ds = ds * jac
            dk = dk + pl.dot(ds.astype(cdt), q, trans_a=True, precision=prec)
            return dk, dv

        return ff.three_loops(ranges, body, carry)

    zeros = jnp.zeros(k.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, rep, head, (zeros, zeros))
    refs["dk"][...] = (dk * scale).astype(refs["dk"].dtype)
    refs["dv"][...] = dv.astype(refs["dv"].dtype)


def _dq_kernel(refs, *, scale, causal, window, softcap, kv_len, block_q,
               block_k, num_kv_blocks, bias_rows):
    q_ref, k_ref, v_ref, do_ref = refs["q"], refs["k"], refs["v"], refs["do"]
    bias_ref, dbias_ref = refs.get("bias"), refs.get("dbias")
    sq_ref, skv_ref = refs.get("seg_q"), refs.get("seg_kv")
    r0 = pl.program_id(0) * block_q
    d = refs["offs"][0] - refs["offs"][1]
    q = q_ref[...]
    do = do_ref[...]
    lse2 = refs["lse"][...] * LOG2E
    delta = refs["delta"][...]
    cdt = q.dtype
    prec = ff.dot_precision(cdt)
    row_idx = r0 + jnp.arange(block_q, dtype=jnp.int32)
    seg_q = sq_ref[...] if sq_ref is not None else None
    ranges = ff.kv_block_range(r0, d, block_q=block_q, block_k=block_k,
                               causal=causal, window=window, kv_len=kv_len,
                               mask_all=seg_q is not None)

    def body(j, dq, masked):
        c0 = j * block_k
        cols = pl.ds(c0, block_k)
        k = k_ref[cols, :]
        bias = None
        if bias_ref is not None:
            bias = (bias_ref[0, cols][None, :] if bias_rows == 1
                    else bias_ref[:, cols])
        s, jac = _scores(q, k, scale=scale, softcap=softcap, bias=bias,
                         prec=prec)
        p = jnp.exp2(s * LOG2E - lse2[:, None])
        if masked:
            mask = ff.pair_mask(
                row_idx, c0 + jnp.arange(block_k, dtype=jnp.int32), d,
                causal=causal, window=window, kv_len=kv_len, seg_q=seg_q,
                seg_kv=skv_ref[cols] if seg_q is not None else None)
            p = jnp.where(mask, p, 0.0)
        dp = pl.dot(do, v_ref[cols, :], trans_b=True, precision=prec)
        ds = p * (dp - delta[:, None])
        if dbias_ref is not None:
            dbias_ref[:, cols] = ds.astype(dbias_ref.dtype)
        if jac is not None:
            ds = ds * jac
        return dq + pl.dot(ds.astype(cdt), k, precision=prec)

    dq = ff.three_loops(ranges, body, jnp.zeros(q.shape, jnp.float32))
    refs["dq"][...] = (dq * scale).astype(refs["dq"].dtype)
    if dbias_ref is not None:
        # Tiles the loop skipped hold no unmasked pair: their gradient is 0.
        lo, hi = ranges[0], ranges[3]
        zero = jnp.zeros((block_q, block_k), dbias_ref.dtype)

        def clear(j, c):
            dbias_ref[:, pl.ds(j * block_k, block_k)] = zero
            return c

        lax.fori_loop(0, lo, clear, 0)
        lax.fori_loop(hi, num_kv_blocks, clear, 0)


def bwd(q, k, v, o, lse, do, *, offsets, scale, causal, window=None,
        softcap=None, bias=None, seg_q=None, seg_kv=None, dkv_config=None,
        dq_config=None, interpret=None):
    """Gradients ``(dq, dk, dv, dbias)`` on unpadded ``[B, H, N, D]``
    inputs; ``dbias`` is ``[B, Hq, Nq, Nk]`` f32 (None without a bias) and
    the caller reduces it over the bias's broadcast dims."""
    if interpret is None:
        interpret = platform.pallas_interpret_default()
    B, Hq, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dp = ff.pad_head_dim(D)
    cls = ff.head_dim_class(D)
    offsets = jnp.asarray(offsets, jnp.int32).reshape(2)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    do = do.astype(q.dtype)
    mask_all = seg_q is not None
    common = dict(scale=float(scale), causal=causal, window=window,
                  softcap=softcap, kv_len=Nk)
    bias_rows = bias.shape[2] if bias is not None else None

    def padded(bq, bk):
        nqp, nkp = ff.round_up(Nq, bq), ff.round_up(Nk, bk)
        ins = dict(
            q=ff.pad_axis(ff.pad_axis(q, 2, nqp), 3, dp),
            k=ff.pad_axis(ff.pad_axis(k, 2, nkp), 3, dp),
            v=ff.pad_axis(ff.pad_axis(v, 2, nkp), 3, dp),
            do=ff.pad_axis(ff.pad_axis(do, 2, nqp), 3, dp),
            lse=ff.pad_axis(lse, 2, nqp), delta=ff.pad_axis(delta, 2, nqp),
            bias=None, seg_q=None, seg_kv=None)
        if bias is not None:
            bp = ff.pad_axis(bias, 3, nkp)
            ins["bias"] = ff.pad_axis(bp, 2, nqp) if bias_rows > 1 else bp
        if mask_all:
            ins["seg_q"] = ff.pad_axis(seg_q.astype(jnp.int32), 1, nqp, -1)
            ins["seg_kv"] = ff.pad_axis(seg_kv.astype(jnp.int32), 1, nkp, -2)
        return nqp, nkp, ins

    # ── dK/dV: grid over (KV tile, batch, kv head) ──
    cfg = ff.for_dtype(dkv_config or ff._DKV_TABLE[cls], q.dtype)
    ff.check_dkv_config(cfg, cls)
    bq = ff.fit_dkv_block_q(cfg.block_q, Nq, cls)
    bk = ff.fit_block(cfg.block_k, Nk)
    nqp, nkp, a = padded(bq, bk)
    group = lambda j, b, h: (b, h, 0, 0)  # noqa: E731  rep q heads of kv h
    inputs = {
        "offs": (pl.BlockSpec((2,), lambda j, b, h: (0,)), offsets),
        "k": (pl.BlockSpec((None, None, bk, dp), lambda j, b, h: (b, h, j, 0)),
              a["k"]),
        "v": (pl.BlockSpec((None, None, bk, dp), lambda j, b, h: (b, h, j, 0)),
              a["v"]),
        "q": (pl.BlockSpec((None, rep, nqp, dp), group), a["q"]),
        "do": (pl.BlockSpec((None, rep, nqp, dp), group), a["do"]),
        "lse": (pl.BlockSpec((None, rep, nqp), lambda j, b, h: (b, h, 0)),
                a["lse"]),
        "delta": (pl.BlockSpec((None, rep, nqp), lambda j, b, h: (b, h, 0)),
                  a["delta"]),
        "bias": (None, None),
        "seg_q": (pl.BlockSpec((None, nqp), lambda j, b, h: (b, 0)),
                  a["seg_q"]),
        "seg_kv": (pl.BlockSpec((None, bk), lambda j, b, h: (b, j)),
                   a["seg_kv"]),
    }
    bias_heads = None
    if bias is not None:
        Bb, bias_heads = bias.shape[0], bias.shape[1]

        def bias_index(j, b, h):
            return (b if Bb > 1 else 0, h if bias_heads > 1 else 0, 0, j)

        inputs["bias"] = (pl.BlockSpec(
            (None, rep if bias_heads > 1 else 1,
             nqp if bias_rows > 1 else 1, bk), bias_index), a["bias"])
    outputs = {
        "dk": (pl.BlockSpec((None, None, bk, dp), lambda j, b, h: (b, h, j, 0)),
               jax.ShapeDtypeStruct((B, Hkv, nkp, dp), k.dtype)),
        "dv": (pl.BlockSpec((None, None, bk, dp), lambda j, b, h: (b, h, j, 0)),
               jax.ShapeDtypeStruct((B, Hkv, nkp, dp), v.dtype)),
    }
    kernel = functools.partial(
        _dkv_kernel, q_len=Nq, block_q=bq, block_k=bk, rep=rep,
        bias_rows=bias_rows, bias_heads=bias_heads, **common)
    outs = ff.launch(kernel, inputs, outputs, grid=(nkp // bk, B, Hkv),
                     config=cfg, name="flash_dkv", interpret=interpret)
    dk = outs["dk"][:, :, :Nk, :D]
    dv = outs["dv"][:, :, :Nk, :D]

    # ── dQ (+ dbias): grid over (Q tile, batch, q head) ──
    cfg = ff.for_dtype(dq_config or ff._DQ_TABLE[cls], q.dtype)
    bq, bk = ff.fit_block(cfg.block_q, Nq), ff.fit_block(cfg.block_k, Nk)
    nqp, nkp, a = padded(bq, bk)

    def kv_head(i, b, h):
        return (b, lax.div(h, rep), 0, 0)

    inputs = {
        "offs": (pl.BlockSpec((2,), lambda i, b, h: (0,)), offsets),
        "q": (pl.BlockSpec((None, None, bq, dp), lambda i, b, h: (b, h, i, 0)),
              a["q"]),
        "k": (pl.BlockSpec((None, None, nkp, dp), kv_head), a["k"]),
        "v": (pl.BlockSpec((None, None, nkp, dp), kv_head), a["v"]),
        "do": (pl.BlockSpec((None, None, bq, dp), lambda i, b, h: (b, h, i, 0)),
               a["do"]),
        "lse": (pl.BlockSpec((None, None, bq), lambda i, b, h: (b, h, i)),
                a["lse"]),
        "delta": (pl.BlockSpec((None, None, bq), lambda i, b, h: (b, h, i)),
                  a["delta"]),
        "bias": (None, None),
        "seg_q": (pl.BlockSpec((None, bq), lambda i, b, h: (b, i)),
                  a["seg_q"]),
        "seg_kv": (pl.BlockSpec((None, nkp), lambda i, b, h: (b, 0)),
                   a["seg_kv"]),
    }
    outputs = {
        "dq": (pl.BlockSpec((None, None, bq, dp), lambda i, b, h: (b, h, i, 0)),
               jax.ShapeDtypeStruct((B, Hq, nqp, dp), q.dtype)),
    }
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]

        def bias_index(i, b, h):
            return (b if Bb > 1 else 0, h if Hb > 1 else 0,
                    i if bias_rows > 1 else 0, 0)

        inputs["bias"] = (pl.BlockSpec(
            (None, None, bq if bias_rows > 1 else 1, nkp), bias_index),
            a["bias"])
        outputs["dbias"] = (
            pl.BlockSpec((None, None, bq, nkp), lambda i, b, h: (b, h, i, 0)),
            jax.ShapeDtypeStruct((B, Hq, nqp, nkp), jnp.float32))
    kernel = functools.partial(
        _dq_kernel, block_q=bq, block_k=bk, num_kv_blocks=nkp // bk,
        bias_rows=bias_rows, **common)
    outs = ff.launch(kernel, inputs, outputs, grid=(nqp // bq, B, Hq),
                     config=cfg, name="flash_dq", interpret=interpret)
    dq = outs["dq"][:, :, :Nq, :D]
    dbias = outs["dbias"][:, :, :Nq, :Nk] if bias is not None else None
    return dq, dk, dv, dbias
