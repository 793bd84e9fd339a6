"""Decoder-only transformer LM (GQA + RoPE + RMSNorm + SwiGLU) on the fused
attention engine.

The LLM-serving role from the north star (BASELINE.json: "LLM inference ...
drop-in SDPA"). Pure-pytree parameters (no framework dependency), activations
kept in ``[B, N, H, D]`` so attention runs in its native BNHD layout with no
host rearrange (the capability behind the reference's ``permute_NH``,
kernel_fp16.cu:327-335).

Three entry points:
  * :func:`transformer_forward` — single-device training/eval forward;
  * :func:`decode_step` / :func:`init_kv_cache` — KV-cache autoregressive
    decode (Nq=1 attention);
  * :func:`make_sharded_train_step` — dp×tp×sp manual-SPMD training step
    (``shard_map``): heads sharded on ``model``, sequence sharded on ``seq``
    with differentiable ring attention, batch on ``data``; gradient psums per
    parameter group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.flash import flash_attention
from flashattn_tpu.ops.quant import (
    QuantizedKV, flash_attention_quantized, quantize_kv,
)
from flashattn_tpu.parallel.ring import ring_attention
from flashattn_tpu.parallel.zigzag import zigzag_order, zigzag_ring_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1408
    rope_theta: float = 10000.0
    # Mistral-style sliding-window attention: each token attends to at most
    # the previous `sliding_window` tokens (None = full causal attention)
    sliding_window: int | None = None
    # Gemma-2-style logit soft-capping (None = off)
    logit_softcap: float | None = None
    # Rematerialize each transformer block in the backward (jax.checkpoint):
    # activations are recomputed instead of stored, trading ~33% more FLOPs
    # for O(layers) less HBM — the standard long-context training lever
    # (SURVEY §7 "checkpoint/remat"). Off by default (short sequences fit).
    remat: bool = False
    dtype: Any = jnp.bfloat16


def _rms_norm(x, w, eps=1e-6):
    xf = x.astype(jnp.float32)
    scale = jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * scale).astype(x.dtype) * w


def _rope(x, positions, theta):
    """Rotary embedding over the last dim of [B, N, H, D]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    angles = positions[:, :, None, None].astype(jnp.float32) * freqs  # B N 1 half
    cos, sin = jnp.cos(angles), jnp.sin(angles)
    x1, x2 = x[..., :half].astype(jnp.float32), x[..., half:].astype(jnp.float32)
    out = jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)
    return out.astype(x.dtype)


def init_transformer(key, cfg: TransformerConfig):
    keys = jax.random.split(key, cfg.n_layers + 2)
    dm, dh = cfg.d_model, cfg.d_head

    def dense(k, shape, fan_in):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        ks = jax.random.split(keys[i], 7)
        layers.append({
            "ln1": jnp.ones((dm,), cfg.dtype),
            "wq": dense(ks[0], (dm, cfg.n_heads, dh), dm),
            "wk": dense(ks[1], (dm, cfg.n_kv_heads, dh), dm),
            "wv": dense(ks[2], (dm, cfg.n_kv_heads, dh), dm),
            "wo": dense(ks[3], (cfg.n_heads, dh, dm), cfg.n_heads * dh),
            "ln2": jnp.ones((dm,), cfg.dtype),
            "w_gate": dense(ks[4], (dm, cfg.d_ff), dm),
            "w_up": dense(ks[5], (dm, cfg.d_ff), dm),
            "w_down": dense(ks[6], (cfg.d_ff, dm), cfg.d_ff),
        })
    return {
        "embed": (jax.random.normal(keys[-2], (cfg.vocab_size, dm), jnp.float32)
                  * 0.02).astype(cfg.dtype),
        "ln_f": jnp.ones((dm,), cfg.dtype),
        "layers": layers,
    }


def _attention_block(layer, x, positions, cfg, attn_fn):
    h = _rms_norm(x, layer["ln1"])
    q = jnp.einsum("bnd,dhe->bnhe", h, layer["wq"])
    k = jnp.einsum("bnd,dhe->bnhe", h, layer["wk"])
    v = jnp.einsum("bnd,dhe->bnhe", h, layer["wv"])
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attn_fn(q, k, v)  # [B, N, H, D]
    return x + jnp.einsum("bnhe,hed->bnd", o, layer["wo"]).astype(x.dtype)


def _mlp_block(layer, x):
    h = _rms_norm(x, layer["ln2"])
    gate = jax.nn.silu(jnp.einsum("bnd,df->bnf", h, layer["w_gate"])
                       .astype(jnp.float32)).astype(x.dtype)
    up = jnp.einsum("bnd,df->bnf", h, layer["w_up"])
    return x + jnp.einsum("bnf,fd->bnd", gate * up, layer["w_down"])


def segment_positions(segment_ids):
    """Per-segment RoPE positions for a packed batch: each contiguous run of
    equal ids restarts at position 0 (``[0,0,1,1,1] → [0,1,0,1,2]``)."""
    B, N = segment_ids.shape
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None], (B, N))
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), segment_ids[:, 1:] != segment_ids[:, :-1]],
        axis=1)
    seg_start = jax.lax.cummax(jnp.where(is_start, idx, 0), axis=1)
    return idx - seg_start


def transformer_forward(params, tokens, cfg: TransformerConfig,
                        *, interpret=None, attn_impl="fused",
                        segment_ids=None):
    """tokens [B, N] int32 → logits [B, N, vocab] f32 (causal LM).

    ``attn_impl``: "fused" routes through the Pallas engine; "xla" computes
    exact unfused softmax attention — the bench baseline playing the
    reference's "PyTorch SDPA math backend" role (same switch as
    models/unet._mha).

    ``segment_ids`` [B, N]: packed-batch training — several documents packed
    into one row, separated by contiguous id runs. Attention is blocked
    across documents (fused kernel segment masking, O(N) ids) and RoPE
    positions restart per document, so packed logits equal the per-document
    logits exactly."""
    B, N = tokens.shape
    x = params["embed"][tokens]
    if segment_ids is not None:
        positions = segment_positions(segment_ids)
    else:
        positions = jnp.broadcast_to(jnp.arange(N)[None], (B, N))

    window = (cfg.sliding_window - 1, -1) if cfg.sliding_window else None

    def attn(q, k, v):
        if attn_impl == "xla":
            from flashattn_tpu.ops.oracle import attention_reference

            o = attention_reference(
                q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
                causal=True, window=window,
                segment_ids=(None if segment_ids is None
                             else (segment_ids, segment_ids)),
                logit_softcap=cfg.logit_softcap)
            return o.swapaxes(1, 2).astype(q.dtype)
        return flash_attention(
            q, k, v, causal=True, layout="BNHD", interpret=interpret,
            window=window, segment_ids=segment_ids,
            logit_softcap=cfg.logit_softcap,
        )

    def block(layer, x):
        x = _attention_block(layer, x, positions, cfg, attn)
        return _mlp_block(layer, x)

    if cfg.remat:
        block = jax.checkpoint(block)
    for layer in params["layers"]:
        x = block(layer, x)
    x = _rms_norm(x, params["ln_f"])
    return jnp.einsum("bnd,vd->bnv", x, params["embed"]).astype(jnp.float32)


def lm_loss(params, tokens, cfg: TransformerConfig, *, interpret=None,
            attn_impl="fused", segment_ids=None):
    """Next-token cross-entropy (mean over all positions).

    With ``segment_ids`` (packed batches), positions whose next token belongs
    to a different document are excluded — a document's last token never
    predicts the next document's first token — and the mean runs over the
    remaining positions."""
    logits = transformer_forward(
        params, tokens[:, :-1], cfg, interpret=interpret,
        attn_impl=attn_impl,
        segment_ids=None if segment_ids is None else segment_ids[:, :-1])
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    if segment_ids is None:
        return -jnp.mean(ll)
    valid = (segment_ids[:, :-1] == segment_ids[:, 1:]).astype(jnp.float32)
    return -jnp.sum(ll * valid) / jnp.maximum(jnp.sum(valid), 1.0)


# ───────────────────────────── decode path ──────────────────────────────────


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  quant_dtype=None):
    """KV cache pytree; ``quant_dtype`` (int8 / float8_e4m3fn) stores the
    cache quantized per token per head, halving its device-memory footprint
    and read bandwidth — dequantization happens inside the attention kernel
    (ops/quant.py)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    cache = {
        "length": jnp.zeros((), jnp.int32),
    }
    if quant_dtype is None:
        cache["k"] = [jnp.zeros(shape, cfg.dtype) for _ in range(cfg.n_layers)]
        cache["v"] = [jnp.zeros(shape, cfg.dtype) for _ in range(cfg.n_layers)]
    else:
        sshape = (batch, max_len, cfg.n_kv_heads)
        cache["k"] = [jnp.zeros(shape, quant_dtype) for _ in range(cfg.n_layers)]
        cache["v"] = [jnp.zeros(shape, quant_dtype) for _ in range(cfg.n_layers)]
        cache["k_scale"] = [jnp.zeros(sshape, jnp.float32)
                            for _ in range(cfg.n_layers)]
        cache["v_scale"] = [jnp.zeros(sshape, jnp.float32)
                            for _ in range(cfg.n_layers)]
    return cache


def decode_step(params, cache, token, cfg: TransformerConfig,
                *, interpret=None):
    """One autoregressive step: token [B] int32 → (logits [B, vocab], cache).

    Attention runs with Nq=1 against the filled cache prefix — the kernel's
    decode shape (Nq=1 is exercised in test_flash_fwd) with the cache length
    masked via the KV tail mask (bias on the padded region).
    """
    B = token.shape[0]
    pos = cache["length"]
    x = params["embed"][token][:, None]  # [B, 1, D]
    positions = jnp.broadcast_to(pos[None, None], (B, 1))
    max_len = cache["k"][0].shape[1]
    # additive mask for not-yet-written cache slots (and, with a sliding
    # window, slots that have scrolled out of the window)
    slot = jnp.arange(max_len)[None, None, None, :]
    live = slot <= pos  # include the token being written this step
    if cfg.sliding_window:
        live = live & (slot > pos - cfg.sliding_window)
    maskbias = jnp.where(live, 0.0, -1e9).astype(jnp.float32)

    quantized = "k_scale" in cache
    if quantized and cfg.logit_softcap:
        raise ValueError(
            "logit_softcap is not supported with a quantized KV cache "
            "(flash_attention_quantized has no softcap path) — decode with "
            "an unquantized cache or disable the cap")
    new_cache = {"k": [], "v": [], "length": pos + 1}
    if quantized:
        new_cache["k_scale"] = []
        new_cache["v_scale"] = []
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln1"])
        q = jnp.einsum("bnd,dhe->bnhe", h, layer["wq"])
        k = jnp.einsum("bnd,dhe->bnhe", h, layer["wk"])
        v = jnp.einsum("bnd,dhe->bnhe", h, layer["wv"])
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        if quantized:
            qt = quantize_kv(k, v, cache["k"][i].dtype)
            kc = jax.lax.dynamic_update_slice_in_dim(
                cache["k"][i], qt.k_q, pos, axis=1)
            vc = jax.lax.dynamic_update_slice_in_dim(
                cache["v"][i], qt.v_q, pos, axis=1)
            ksc = jax.lax.dynamic_update_slice_in_dim(
                cache["k_scale"][i], qt.k_scale, pos, axis=1)
            vsc = jax.lax.dynamic_update_slice_in_dim(
                cache["v_scale"][i], qt.v_scale, pos, axis=1)
            new_cache["k"].append(kc)
            new_cache["v"].append(vc)
            new_cache["k_scale"].append(ksc)
            new_cache["v_scale"].append(vsc)
            o = flash_attention_quantized(
                q, QuantizedKV(kc, ksc, vc, vsc), layout="BNHD",
                bias=maskbias, interpret=interpret,
            )
        else:
            kc = jax.lax.dynamic_update_slice_in_dim(
                cache["k"][i], k, pos, axis=1)
            vc = jax.lax.dynamic_update_slice_in_dim(
                cache["v"][i], v, pos, axis=1)
            new_cache["k"].append(kc)
            new_cache["v"].append(vc)
            o = flash_attention(
                q, kc, vc, causal=False, layout="BNHD", bias=maskbias,
                interpret=interpret, logit_softcap=cfg.logit_softcap,
            )
        x = x + jnp.einsum("bnhe,hed->bnd", o, layer["wo"]).astype(x.dtype)
        x = _mlp_block(layer, x)
    x = _rms_norm(x, params["ln_f"])
    logits = jnp.einsum("bnd,vd->bnv", x, params["embed"])[:, 0]
    return logits.astype(jnp.float32), new_cache


# ───────────────────────── sharded training step ─────────────────────────────


def shard_params_leaf_rules(cfg: TransformerConfig):
    """PartitionSpec per layer-param name for tp ("model" axis) sharding."""
    from jax.sharding import PartitionSpec as P

    return {
        "ln1": P(), "ln2": P(),
        "wq": P(None, "model", None), "wk": P(None, "model", None),
        "wv": P(None, "model", None), "wo": P("model", None, None),
        "w_gate": P(None, "model"), "w_up": P(None, "model"),
        "w_down": P("model", None),
    }


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_enter(x, axis):
    """Entry of a tensor-parallel region (Megatron's f): identity forward;
    the backward sums the shards' partial cotangents, each of which covers
    only the local heads / MLP columns."""
    return x


def _tp_enter_fwd(x, axis):
    return x, None


def _tp_enter_bwd(axis, _, ct):
    return (jax.lax.psum(ct, axis),)


_tp_enter.defvjp(_tp_enter_fwd, _tp_enter_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_exit(x, axis):
    """Exit of a tensor-parallel region (Megatron's g): sums the shards'
    partial outputs forward; the cotangent, identical on every shard, passes
    back unchanged (under ``check_vma=False`` a plain psum would transpose
    to a second psum and scale it by the axis size)."""
    return jax.lax.psum(x, axis)


def _tp_exit_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _tp_exit_bwd(axis, _, ct):
    return (ct,)


_tp_exit.defvjp(_tp_exit_fwd, _tp_exit_bwd)


def _zigzag_positions(seq_idx, n_local, sp):
    """Global positions of a device's zigzag-layout local rows: natural
    chunks (d, 2·sp−1−d) of length n_local/2 concatenated."""
    c = n_local // 2
    return jnp.concatenate([jnp.arange(c) + seq_idx * c,
                            jnp.arange(c) + (2 * sp - 1 - seq_idx) * c])


def _local_forward_sharded(params, tokens, cfg, mesh_shape, *, interpret,
                           zigzag=False, segment_ids=None, positions=None):
    """Per-shard forward: params carry local (tp-sharded) head/ff slices;
    tokens are the local [B/dp, N/sp] chunk. Ring attention over 'seq' —
    plain (contiguous layout) or zigzag (causally load-balanced layout;
    RoPE positions follow the layout so the math is identical).

    ``segment_ids``/``positions``: local chunks for packed batches
    (contiguous layout only). Positions are computed *globally* by the
    caller (a packed document may straddle shard boundaries, so per-shard
    position restarts would be wrong) and passed in sharded."""
    sp = mesh_shape["seq"]
    seq_idx = jax.lax.axis_index("seq")
    B, N = tokens.shape
    if positions is None:
        if zigzag:
            positions = jnp.broadcast_to(
                _zigzag_positions(seq_idx, N, sp)[None], (B, N))
        else:
            pos0 = seq_idx * N
            positions = jnp.broadcast_to(jnp.arange(N)[None] + pos0, (B, N))
    x = params["embed"][tokens]

    def attn(q, k, v):
        # [B, N/sp, Hloc, D] -> BHND for the ring
        qh, kh, vh = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
        if zigzag:
            o = zigzag_ring_attention(
                qh, kh, vh, axis_name="seq", axis_size=sp)
        else:
            o = ring_attention(
                qh, kh, vh, axis_name="seq", axis_size=sp, causal=True,
                segment_ids=segment_ids,
            )
        return o.transpose(0, 2, 1, 3)

    for layer in params["layers"]:
        h = _tp_enter(_rms_norm(x, layer["ln1"]), "model")
        q = jnp.einsum("bnd,dhe->bnhe", h, layer["wq"])
        k = jnp.einsum("bnd,dhe->bnhe", h, layer["wk"])
        v = jnp.einsum("bnd,dhe->bnhe", h, layer["wv"])
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        o = attn(q, k, v)
        # wo is row-sharded over heads -> partial sums -> psum over tp
        attn_out = _tp_exit(
            jnp.einsum("bnhe,hed->bnd", o, layer["wo"]), "model"
        )
        x = x + attn_out.astype(x.dtype)
        h2 = _tp_enter(_rms_norm(x, layer["ln2"]), "model")
        gate = jax.nn.silu(
            jnp.einsum("bnd,df->bnf", h2, layer["w_gate"]).astype(jnp.float32)
        ).astype(x.dtype)
        up = jnp.einsum("bnd,df->bnf", h2, layer["w_up"])
        mlp_out = _tp_exit(
            jnp.einsum("bnf,fd->bnd", gate * up, layer["w_down"]), "model"
        )
        x = x + mlp_out.astype(x.dtype)
    x = _rms_norm(x, params["ln_f"])
    return jnp.einsum("bnd,vd->bnv", x, params["embed"]).astype(jnp.float32)


def adamw_init(params):
    """AdamW state mirroring the param tree (shardable with the same specs)."""
    zeros = jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32),
                                   params)
    return {"mu": zeros,
            "nu": jax.tree_util.tree_map(jnp.copy, zeros),
            "count": jnp.zeros((), jnp.int32)}


def adamw_update(grads, state, params, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.01):
    count = state["count"] + 1
    cf = count.astype(jnp.float32)

    def upd(g, m, n, p):
        gf = g.astype(jnp.float32)
        m = b1 * m + (1 - b1) * gf
        n = b2 * n + (1 - b2) * gf * gf
        mhat = m / (1 - b1 ** cf)
        nhat = n / (1 - b2 ** cf)
        step = mhat / (jnp.sqrt(nhat) + eps) + weight_decay * p.astype(jnp.float32)
        return (p.astype(jnp.float32) - lr * step).astype(p.dtype), m, n

    flat_g, treedef = jax.tree_util.tree_flatten(grads)
    flat_m = treedef.flatten_up_to(state["mu"])
    flat_n = treedef.flatten_up_to(state["nu"])
    flat_p = treedef.flatten_up_to(params)
    out = [upd(g, m, n, p) for g, m, n, p in zip(flat_g, flat_m, flat_n, flat_p)]
    new_p = treedef.unflatten([o[0] for o in out])
    new_state = {"mu": treedef.unflatten([o[1] for o in out]),
                 "nu": treedef.unflatten([o[2] for o in out]),
                 "count": count}
    return new_p, new_state


def make_sharded_train_step(mesh, cfg: TransformerConfig, *, lr=1e-3,
                            interpret=None, seq_layout="contiguous",
                            with_segment_ids=False):
    """Build ``(params, opt_state, tokens) -> (params, opt_state, loss)``
    jitted over a (data, model, seq) mesh.

    Parallelism map (SURVEY.md §2.5 build plan):
      * data  — batch DP; grads psum'd across it,
      * model — TP: attention heads + MLP columns sharded; activations
        replicated; psum after wo / w_down,
      * seq   — SP: sequence sharded; differentiable ring attention rotates
        KV between devices (ppermute); grads of replicated params psum'd
        across it.
    PP/EP: N/A for this model family (reference has no pipeline/MoE;
    SURVEY.md §2.5 documents them as out of scope).

    ``seq_layout``: "contiguous" (default) or "zigzag" — the causally
    load-balanced layout (parallel/zigzag.py). Tokens are still passed in
    natural order; the step permutes them once on the way in. RoPE
    positions, attention masks, and the next-token loss all follow the
    layout, so the loss is identical to the contiguous one — only the
    per-device work distribution changes.

    ``with_segment_ids``: the returned step takes
    ``(params, opt_state, tokens, segment_ids)`` for packed batches:
    ring attention rotates the kv ids, RoPE positions (computed on the
    global ids, since documents may straddle seq shards) restart per
    document, and the loss masks document boundaries — sp>1 packed loss
    equals the single-device packed loss exactly. Contiguous layout only.
    """
    from jax.sharding import PartitionSpec as P

    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r}")
    zz = seq_layout == "zigzag"
    if with_segment_ids and zz:
        raise ValueError(
            "packed batches (with_segment_ids) require "
            "seq_layout='contiguous' — the zigzag layout does not thread "
            "segment ids yet")

    mesh_shape = dict(mesh.shape)
    rules = shard_params_leaf_rules(cfg)
    batch_axes = ("data",)

    def param_specs():
        layer_spec = {k: rules[k] for k in rules}
        return {
            "embed": P(),
            "ln_f": P(),
            "layers": [dict(layer_spec) for _ in range(cfg.n_layers)],
        }

    pspecs = param_specs()
    tok_spec = P(batch_axes, "seq")

    def local_loss(params, tokens, seg=None, positions=None):
        sp = mesh_shape["seq"]
        B, nloc = tokens.shape
        logits = _local_forward_sharded(
            params, tokens, cfg, mesh_shape, interpret=interpret, zigzag=zz,
            segment_ids=seg, positions=positions,
        )
        # Next-token targets with a one-token halo: the target of each
        # shard's last position is the NEXT shard's first token (ppermute),
        # so the sp>1 loss equals the sp=1 loss exactly; the global final
        # position (whose halo wrapped around the ring) is masked out.
        seq_idx = jax.lax.axis_index("seq")
        if zz:
            # Two halos, one per zigzag half: lo (natural chunk d) is
            # followed by chunk d+1 = device d+1's lo half — except the
            # last device, whose lo chunk sp−1 is followed by its OWN hi
            # half (chunk sp). hi (chunk 2sp−1−d) is followed by chunk
            # 2sp−d = device d−1's hi half; device 0's hi is the global
            # tail, masked below.
            c = nloc // 2
            lo, hi = tokens[:, :c], tokens[:, c:]
            if sp > 1:
                nxt_lo = jax.lax.ppermute(
                    lo[:, :1], "seq",
                    [(i, (i - 1) % sp) for i in range(sp)])
                nxt_hi = jax.lax.ppermute(
                    hi[:, :1], "seq",
                    [(i, (i + 1) % sp) for i in range(sp)])
            else:
                nxt_lo = nxt_hi = hi[:, :1]
            nxt_lo = jnp.where(seq_idx == sp - 1, hi[:, :1], nxt_lo)
            targets = jnp.concatenate(
                [lo[:, 1:], nxt_lo, hi[:, 1:], nxt_hi], axis=1)
            gpos = _zigzag_positions(seq_idx, nloc, sp)[None]
        else:
            if sp > 1:
                nxt = jax.lax.ppermute(
                    tokens[:, :1], "seq",
                    [(i, (i - 1) % sp) for i in range(sp)])
            else:
                nxt = tokens[:, :1]
            targets = jnp.concatenate([tokens[:, 1:], nxt], axis=1)
            gpos = seq_idx * nloc + jnp.arange(nloc)[None]
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        valid = jnp.broadcast_to(gpos < sp * nloc - 1, ll.shape)
        if seg is not None:
            # Packed batches: a document's last token must not predict the
            # next document's first. The target segment id needs the same
            # one-token halo as the target itself.
            if sp > 1:
                nxt_seg = jax.lax.ppermute(
                    seg[:, :1], "seq",
                    [(i, (i - 1) % sp) for i in range(sp)])
            else:
                nxt_seg = seg[:, :1]
            seg_next = jnp.concatenate([seg[:, 1:], nxt_seg], axis=1)
            valid = jnp.logical_and(valid, seg == seg_next)
        # This shard's share of the mean over the global batch x (seq-1):
        # its own sum over the global count. Differentiating the share (not
        # a psum of it, whose transpose would scale the cotangent by the
        # number of shards) gives this shard's gradient contribution.
        count = jax.lax.psum(jnp.sum(valid), (*batch_axes, "seq"))
        # all-length-1 documents can make every position a boundary
        return jnp.sum(jnp.where(valid, -ll, 0.0)) / jnp.maximum(count, 1)

    def step(params, opt_state, tokens, seg=None, positions=None):
        share, grads = jax.value_and_grad(local_loss)(
            params, tokens, seg, positions)
        axes = (*batch_axes, "seq")
        loss = jax.lax.psum(share, axes)
        # The tp entry/exit operators leave every leaf's gradient complete
        # over the model axis (replicated leaves identical on each shard);
        # the data and seq shards' contributions sum.
        grads = jax.tree_util.tree_map(lambda g: jax.lax.psum(g, axes),
                                       grads)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss

    opt_specs = {"mu": pspecs, "nu": pspecs, "count": P()}
    if with_segment_ids:
        seg_spec = P(batch_axes, "seq")
        mapped = jax.shard_map(
            step, mesh=mesh,
            in_specs=(pspecs, opt_specs, tok_spec, seg_spec, seg_spec),
            out_specs=(pspecs, opt_specs, P()),
            check_vma=False,
        )

        def run_seg(params, opt_state, tokens, segment_ids):
            # RoPE positions restart per packed document; a document may
            # straddle seq shards, so positions are computed on the GLOBAL
            # ids here and sharded into the step alongside them.
            return mapped(params, opt_state, tokens, segment_ids,
                          segment_positions(segment_ids))

        return jax.jit(run_seg), pspecs, opt_specs
    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(pspecs, opt_specs, tok_spec),
        out_specs=(pspecs, opt_specs, P()),
        check_vma=False,
    )
    if zz:
        sp = mesh_shape["seq"]

        def run(params, opt_state, tokens):
            # natural order in; one gather into the zigzag layout
            return mapped(params, opt_state,
                          tokens[:, zigzag_order(tokens.shape[1], sp)])

        return jax.jit(run), pspecs, opt_specs
    return jax.jit(mapped), pspecs, opt_specs
