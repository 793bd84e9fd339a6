"""FlashAttention-2 forward kernel for Hopper (Pallas, Triton route).

One program per (q tile, batch, q head). The program loads its Q tile once,
then walks the KV tiles that can hold an unmasked pair with a
``lax.fori_loop`` whose bounds come from the causal/window geometry and the
q/kv position offsets, so masked-out tiles are never visited. The online
softmax state (running max ``m``, running sum ``l`` and the f32 output
accumulator) stays in registers; scores are kept in the log2 domain so the
exponentials are ``exp2``. The row log-sum-exp ``L = m + log(l)`` (natural
log) is written as ``[B, H, Nq]`` for the backward and for ring merges.

Per tile, the visited KV range splits into three loops: edge tiles before
and after an interior run that needs no mask, so the interior pays no mask
arithmetic. Bias, packed-sequence ids, logit soft-capping and per-token
int8/fp8 K/V scales are applied as each tile is loaded. GQA maps q head
``h`` to kv head ``h // rep``.

Inputs reach :func:`fwd` unpadded; it pads the sequence axes to the block
sizes and the head dimension to a power of two (Triton tiles are powers of
two), launches the kernel and slices the result.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flashattn_tpu.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu.utils import platform

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
MIN_BLOCK = 16  # smallest tile side the tensor-core dot accepts


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Tile sizes and launch parameters for one kernel."""

    block_q: int
    block_k: int
    num_warps: int
    num_stages: int


# Hopper launch table keyed by padded head dim (64 covers D <= 64, 128 covers
# 65..128, 256 covers 129..256): the fastest of the candidates that
# benchmarks/tune_blocks.py timed on an H100 at B1 H16 N4096 bf16, among
# those that also passed chip_smoke.py on the card (PERF.md): the faster
# D=64 forward (128, 128) overflowed shared memory with a bias, and the
# faster D=128 dK/dV tiles with a 32-row Q step returned wrong dK
# (DKV_REFUSED_BLOCK_Q below).
# dK/dV tiles KV by block_k and steps Q by block_q; dQ the transpose.
_FWD_TABLE = {
    64: KernelConfig(128, 64, 4, 3),
    128: KernelConfig(128, 64, 8, 3),
    256: KernelConfig(128, 32, 8, 2),
}
_DKV_TABLE = {
    64: KernelConfig(64, 64, 4, 2),
    128: KernelConfig(64, 64, 8, 2),
    256: KernelConfig(32, 64, 8, 1),
}
_DQ_TABLE = {
    64: KernelConfig(64, 64, 4, 2),
    128: KernelConfig(128, 32, 8, 3),
    256: KernelConfig(64, 32, 8, 1),
}


def for_dtype(cfg: KernelConfig, dtype) -> KernelConfig:
    """f32 tiles take twice the bytes and the six-pass product keeps three
    bf16 splits of each operand: at the bf16 tiles they overflowed the
    227 KB of shared memory on the H100, so f32 runs single-stage tiles of
    at most 64×32."""
    if jnp.dtype(dtype) != jnp.float32:
        return cfg
    return KernelConfig(min(cfg.block_q, 64), min(cfg.block_k, 32),
                        cfg.num_warps, 1)


def head_dim_class(d: int) -> int:
    return 64 if d <= 64 else (128 if d <= 128 else 256)


def pad_head_dim(d: int) -> int:
    """Triton tiles are powers of two: D=40/80/160 pad to 64/128/256."""
    return max(MIN_BLOCK, pl.next_power_of_2(d))


def fit_block(block: int, n: int) -> int:
    """Shrink a tile to the smallest power of two >= n (>= 16), so short
    sequences (decode's single query) do not pad to a full tile."""
    return max(MIN_BLOCK, min(block, pl.next_power_of_2(max(n, 1))))


# dK/dV Q steps refused per head-dim class. At class 128 a 32-row step
# compiled but computed wrong dK on an H100 (at 2 and 3 stages, at 4 and 8
# warps; max-abs errors 6e-3 to 0.13 where sound tiles read 1.1e-3), while
# 16- and 64-row steps at the same settings were right (PERF.md). Until the
# cause is known such a step is refused, and short sequences step by 64.
DKV_REFUSED_BLOCK_Q = {128: 32}


def check_dkv_config(cfg: KernelConfig, cls: int) -> None:
    if DKV_REFUSED_BLOCK_Q.get(cls) == cfg.block_q:
        raise ValueError(
            f"dK/dV block_q={cfg.block_q} at head-dim class {cls} computed "
            "wrong dK on an H100; use another power of two")


def fit_dkv_block_q(block: int, n: int, cls: int) -> int:
    """:func:`fit_block` for the dK/dV kernel's Q step, skipping a refused
    step size."""
    bq = fit_block(block, n)
    return 2 * bq if DKV_REFUSED_BLOCK_Q.get(cls) == bq else bq


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_axis(x, axis, target, value=0):
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def _div(a, b):
    """Integer division of a non-negative traced int32 by a positive int."""
    return lax.div(a, jnp.int32(b))


def _cdiv(a, b):
    return _div(a + (b - 1), b)


def kv_block_range(r0, d, *, block_q, block_k, causal, window, kv_len,
                   mask_all):
    """KV-tile ranges for the q rows ``[r0, r0 + block_q)``.

    ``d = q_offset - kv_offset``: local row ``i`` and local column ``j`` sit
    at absolute positions ``i + q_offset`` and ``j + kv_offset``. Returns
    ``(lo, full_lo, full_hi, hi)``: tiles ``[lo, hi)`` hold at least one
    unmasked pair, and tiles ``[full_lo, full_hi)`` hold no masked pair.
    ``mask_all`` (segment ids) makes every visited tile an edge tile.
    """
    wl, wr = window if window is not None else (-1, -1)
    hi_col = jnp.int32(kv_len)
    full_col = jnp.int32(kv_len)
    if causal:
        hi_col = jnp.minimum(hi_col, r0 + block_q + d)
        full_col = jnp.minimum(full_col, r0 + d + 1)
    elif wr >= 0:
        hi_col = jnp.minimum(hi_col, r0 + block_q + d + wr)
        full_col = jnp.minimum(full_col, r0 + d + wr + 1)
    hi = _cdiv(jnp.maximum(hi_col, 0), block_k)
    lo = jnp.int32(0)
    full_lo = jnp.int32(0)
    if wl >= 0:
        lo = jnp.minimum(_div(jnp.maximum(r0 + d - wl, 0), block_k), hi)
        full_lo = _cdiv(jnp.maximum(r0 + block_q - 1 + d - wl, 0), block_k)
    if mask_all:
        return lo, hi, hi, hi
    full_lo = jnp.clip(full_lo, lo, hi)
    full_hi = jnp.clip(_div(jnp.maximum(full_col, 0), block_k), full_lo, hi)
    return lo, full_lo, full_hi, hi


def pair_mask(rows, cols, d, *, causal, window, kv_len, seg_q=None,
              seg_kv=None):
    """Element mask of a (rows × cols) tile; True = attend."""
    wl, wr = window if window is not None else (-1, -1)
    mask = cols[None, :] < kv_len
    rel = cols[None, :] - rows[:, None] - d   # j_abs - i_abs
    if causal:
        mask = jnp.logical_and(mask, rel <= 0)
    elif wr >= 0:
        mask = jnp.logical_and(mask, rel <= wr)
    if wl >= 0:
        mask = jnp.logical_and(mask, rel >= -wl)
    if seg_q is not None:
        mask = jnp.logical_and(mask, seg_q[:, None] == seg_kv[None, :])
    return mask


def three_loops(ranges, body, carry):
    """Run ``body(j, carry, masked)`` over edge, interior and edge tiles."""
    lo, full_lo, full_hi, hi = ranges
    carry = lax.fori_loop(lo, full_lo, functools.partial(body, masked=True),
                          carry)
    carry = lax.fori_loop(full_lo, full_hi,
                          functools.partial(body, masked=False), carry)
    return lax.fori_loop(full_hi, hi, functools.partial(body, masked=True),
                         carry)


def dot_precision(dtype):
    """Products of f32 inputs run as six bf16 tensor-core passes (split
    operands, f32 accumulation): f32-class accuracy. The default would be
    TF32 (10-bit mantissa); IEEE f32 bypasses the tensor cores and measured
    ~100× slower on the H100."""
    return (lax.DotAlgorithmPreset.BF16_BF16_F32_X6
            if jnp.dtype(dtype) == jnp.float32 else None)


def _fwd_kernel(refs, *, scale, causal, window, softcap, kv_len, block_q,
                block_k, num_q_blocks, bias_rows):
    """``refs``: dict of the present input/output refs by name."""
    q_ref, k_ref, v_ref = refs["q"], refs["k"], refs["v"]
    bias_ref, ks_ref, vs_ref = refs.get("bias"), refs.get("ks"), refs.get("vs")
    sq_ref, skv_ref = refs.get("seg_q"), refs.get("seg_kv")
    offs_ref = refs["offs"]
    qi = num_q_blocks - 1 - pl.program_id(0)   # heaviest causal tiles first
    r0 = qi * block_q
    d = offs_ref[0] - offs_ref[1]
    q = q_ref[...]
    cdt = q.dtype
    prec = dot_precision(cdt)
    rows = r0 + jnp.arange(block_q, dtype=jnp.int32)
    seg_q = sq_ref[...] if sq_ref is not None else None
    ranges = kv_block_range(r0, d, block_q=block_q, block_k=block_k,
                            causal=causal, window=window, kv_len=kv_len,
                            mask_all=seg_q is not None)

    def body(j, carry, masked):
        acc, m, l = carry
        c0 = j * block_k
        cols = pl.ds(c0, block_k)
        k = k_ref[cols, :]
        if k.dtype != cdt:
            k = k.astype(cdt)
        s = pl.dot(q, k, trans_b=True, precision=prec)
        if ks_ref is not None:
            s = s * ks_ref[cols][None, :]
        if softcap is not None:
            s = (softcap * LOG2E) * jnp.tanh(s * (scale / softcap))
        else:
            s = s * (scale * LOG2E)
        if bias_ref is not None:
            b = (bias_ref[0, cols][None, :] if bias_rows == 1
                 else bias_ref[:, cols])
            s = s + b.astype(jnp.float32) * LOG2E
        if masked:
            col_idx = c0 + jnp.arange(block_k, dtype=jnp.int32)
            mask = pair_mask(
                rows, col_idx, d, causal=causal, window=window, kv_len=kv_len,
                seg_q=seg_q, seg_kv=skv_ref[cols] if seg_q is not None
                else None)
            s = jnp.where(mask, s, DEFAULT_MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = l * alpha + jnp.sum(p, axis=1)
        if vs_ref is not None:
            p = p * vs_ref[cols][None, :]
        v = v_ref[cols, :]
        if v.dtype != cdt:
            v = v.astype(cdt)
        acc = acc * alpha[:, None] + pl.dot(p.astype(cdt), v, precision=prec)
        return acc, m_new, l

    acc = jnp.zeros(q.shape, jnp.float32)
    m = jnp.full((block_q,), -jnp.inf, jnp.float32)
    l = jnp.zeros((block_q,), jnp.float32)
    acc, m, l = three_loops(ranges, body, (acc, m, l))
    # Dead rows (every pair masked, or no tile visited) store zeros and a
    # finite very negative LSE: the package-wide convention shared with the
    # oracle; ring merges treat that LSE as -inf through logaddexp.
    dead = m <= DEFAULT_MASK_VALUE * 0.5
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = jnp.where(dead[:, None], 0.0, acc / l_safe[:, None])
    refs["o"][...] = o.astype(refs["o"].dtype)
    if "lse" in refs:
        refs["lse"][...] = jnp.where(dead, LN2 * DEFAULT_MASK_VALUE,
                                 (m + jnp.log2(l_safe)) * LN2)


def launch(kernel, inputs, outputs, *, grid, config, name, interpret):
    """``pallas_call`` on the Triton route with named, optional operands.

    ``inputs``/``outputs``: ordered ``{name: (BlockSpec, array|shape)}``;
    entries whose array is None are left out, and the kernel receives a
    dict of the refs that are present.
    """
    live = [(n, s, a) for n, (s, a) in inputs.items() if a is not None]
    names = [n for n, _, _ in live] + list(outputs)

    def entry(*refs):
        kernel(dict(zip(names, refs)))

    with jax.named_scope(name):
        outs = pl.pallas_call(
            entry,
            grid=grid,
            in_specs=[s for _, s, _ in live],
            out_specs=[s for s, _ in outputs.values()],
            out_shape=[a for _, a in outputs.values()],
            compiler_params=plgpu.CompilerParams(
                num_warps=config.num_warps, num_stages=config.num_stages),
            backend="triton",
            interpret=interpret,
            name=name,
        )(*[a for _, _, a in live])
    return dict(zip(outputs, outs))


def fwd(q, k, v, *, offsets, scale, causal, window=None, softcap=None,
        bias=None, k_scale=None, v_scale=None, seg_q=None, seg_kv=None,
        return_lse=False, config=None, interpret=None):
    """Forward attention on unpadded ``[B, H, N, D]`` inputs.

    ``offsets``: int32 ``[q_offset, kv_offset]`` (may be traced).
    ``bias``: ``[Bb, Hb, Nq|1, Nk]`` with Bb in {1, B}, Hb in {1, Hq}.
    ``k_scale``/``v_scale``: per-token ``[B, Hkv, Nk]`` f32 dequant scales
    for int8/fp8 K/V. ``seg_q``/``seg_kv``: ``[B, Nq]``/``[B, Nk]`` ids.
    Returns ``(o, lse)`` with ``lse`` None unless ``return_lse``.
    """
    if interpret is None:
        interpret = platform.pallas_interpret_default()
    B, Hq, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dp = pad_head_dim(D)
    cfg = for_dtype(config or _FWD_TABLE[head_dim_class(D)], q.dtype)
    bq = fit_block(cfg.block_q, Nq)
    bk = fit_block(cfg.block_k, Nk)
    nqp, nkp = round_up(Nq, bq), round_up(Nk, bk)
    nqb = nqp // bq

    qp = pad_axis(pad_axis(q, 2, nqp), 3, dp)
    kp = pad_axis(pad_axis(k, 2, nkp), 3, dp)
    vp = pad_axis(pad_axis(v, 2, nkp), 3, dp)

    def q_rows(i, b, h):
        return nqb - 1 - i

    def kv_head(i, b, h):
        return (b, lax.div(h, rep), 0)

    inputs = {
        "offs": (pl.BlockSpec((2,), lambda i, b, h: (0,)),
                 jnp.asarray(offsets, jnp.int32).reshape(2)),
        "q": (pl.BlockSpec((None, None, bq, dp),
                           lambda i, b, h: (b, h, q_rows(i, b, h), 0)), qp),
        "k": (pl.BlockSpec((None, None, nkp, dp),
                           lambda i, b, h: (*kv_head(i, b, h), 0)), kp),
        "v": (pl.BlockSpec((None, None, nkp, dp),
                           lambda i, b, h: (*kv_head(i, b, h), 0)), vp),
        "bias": (None, None),
        "ks": (pl.BlockSpec((None, None, nkp), kv_head),
               None if k_scale is None
               else pad_axis(k_scale.astype(jnp.float32), 2, nkp)),
        "vs": (pl.BlockSpec((None, None, nkp), kv_head),
               None if v_scale is None
               else pad_axis(v_scale.astype(jnp.float32), 2, nkp)),
        "seg_q": (pl.BlockSpec((None, bq), lambda i, b, h: (b, q_rows(
            i, b, h))), None),
        "seg_kv": (pl.BlockSpec((None, nkp), lambda i, b, h: (b, 0)), None),
    }
    bias_rows = None
    if bias is not None:
        Bb, Hb, bias_rows, _ = bias.shape
        bp = pad_axis(bias, 3, nkp)
        if bias_rows > 1:
            bp = pad_axis(bp, 2, nqp)

        def bias_index(i, b, h):
            return (b if Bb > 1 else 0, h if Hb > 1 else 0,
                    q_rows(i, b, h) if bias_rows > 1 else 0, 0)

        inputs["bias"] = (pl.BlockSpec(
            (None, None, bq if bias_rows > 1 else 1, nkp), bias_index), bp)
    if seg_q is not None:
        # Distinct padding ids: padded rows and columns match nothing.
        inputs["seg_q"] = (inputs["seg_q"][0],
                           pad_axis(seg_q.astype(jnp.int32), 1, nqp, -1))
        inputs["seg_kv"] = (inputs["seg_kv"][0],
                            pad_axis(seg_kv.astype(jnp.int32), 1, nkp, -2))

    outputs = {"o": (pl.BlockSpec((None, None, bq, dp),
                                  lambda i, b, h: (b, h, q_rows(i, b, h), 0)),
                     jax.ShapeDtypeStruct((B, Hq, nqp, dp), q.dtype))}
    if return_lse:
        outputs["lse"] = (pl.BlockSpec(
            (None, None, bq), lambda i, b, h: (b, h, q_rows(i, b, h))),
            jax.ShapeDtypeStruct((B, Hq, nqp), jnp.float32))

    kernel = functools.partial(
        _fwd_kernel, scale=float(scale), causal=causal, window=window,
        softcap=softcap, kv_len=Nk, block_q=bq, block_k=bk,
        num_q_blocks=nqb, bias_rows=bias_rows)
    outs = launch(kernel, inputs, outputs, grid=(nqb, B, Hq), config=cfg,
                  name="flash_fwd", interpret=interpret)
    o = outs["o"][:, :, :Nq, :D]
    lse = outs["lse"][:, :, :Nq] if return_lse else None
    return o, lse
