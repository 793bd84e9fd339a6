"""LLM training-step benchmark: tokens/s at the causal train shape.

The training-side counterpart of bench_decode (the north star adds LLM
paths beyond the reference's SD tables): one full-parameter AdamW step of a
Llama-class LM — every attention forward AND backward runs the causal
kernels — fused engine vs exact-softmax XLA attention (the reference's
"PyTorch SDPA math backend" role), with a loss-equality numerics gate and
the compiled peak-memory column. The O(N) vs O(N²) training-memory claim is
measured end-to-end here: the XLA arm materializes every layer's [H, N, N]
score tensor through the backward.

Run (on the GPU):  python benchmarks/bench_lm.py [--quick]
Each result prints as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from flashattn_tpu.utils.platform import device_record, enable_compilation_cache

enable_compilation_cache()

from flashattn_tpu.models.transformer import (
    TransformerConfig, adamw_init, adamw_update, init_transformer, lm_loss,
)
from flashattn_tpu.utils.timing import time_chained
from benchmarks.bench_diffusion import peak_memory_bytes


def build_step(cfg, attn_impl, packed=False):
    def step(carry, tokens, *seg):
        params, opt = carry
        loss, grads = jax.value_and_grad(
            lambda p: lm_loss(p, tokens, cfg, attn_impl=attn_impl,
                              segment_ids=seg[0] if packed else None)
        )(params)
        params, opt = adamw_update(grads, opt, params)
        return params, opt

    return step


def bench_one(cfg, batch, seqlen, attn_impl, iters, packed=False):
    params = jax.jit(lambda k: init_transformer(k, cfg))(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    opt = adamw_init(params)
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (batch, seqlen + 1), 0, cfg.vocab_size)
    consts = (tokens,)
    if packed:
        # 8 packed documents per row — the production varlen-batch shape;
        # quantifies the segment-masking cost vs the plain causal step
        # (segments force the flat/dense grid + two-pass backward).
        seg = jnp.repeat(
            jnp.arange(8, dtype=jnp.int32),
            (seqlen + 1 + 7) // 8)[None, :seqlen + 1]
        consts = (tokens, jnp.broadcast_to(seg, tokens.shape))
    step = build_step(cfg, attn_impl, packed=packed)

    rec = {"bench": "lm_train",
           "impl": attn_impl + ("-packed" if packed else ""), "batch": batch,
           "seqlen": seqlen, "d_model": cfg.d_model,
           "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
           **({"sliding_window": cfg.sliding_window}
              if cfg.sliding_window else {}),
           **({"remat": True} if cfg.remat else {})}
    try:
        t = time_chained(step, (params, opt), consts=consts, iters=iters,
                         warmup_iters=max(1, min(iters - 1, iters // 4)),
                         repeats=2)
        mem = peak_memory_bytes(step, (params, opt), *consts)
    except Exception as e:  # XLA arm can OOM on the O(N²) score tensors
        rec["status"] = f"failed: {type(e).__name__}"
        print(json.dumps(rec), flush=True)
        return None
    rec.update({
        "tokens_per_s": round(batch * seqlen / t, 1),
        "ms_per_step": round(t * 1e3, 2),
        "peak_mem_gb": round(mem / 2**30, 3) if mem else None,
    })
    print(json.dumps(rec), flush=True)
    return rec


def loss_gate(cfg, batch, seqlen):
    """Fused and XLA losses on the same params/tokens must agree — the
    bench doubles as an on-chip integration test (bench_with_sdpa.py role)."""
    params = jax.jit(lambda k: init_transformer(k, cfg))(jax.random.PRNGKey(0))
    tokens = jax.random.randint(
        jax.random.PRNGKey(1), (batch, seqlen + 1), 0, cfg.vocab_size)
    lf = float(jax.jit(
        lambda p, t: lm_loss(p, t, cfg, attn_impl="fused"))(params, tokens))
    lx = float(jax.jit(
        lambda p, t: lm_loss(p, t, cfg, attn_impl="xla"))(params, tokens))
    diff = abs(lf - lx)
    ok = diff < max(5e-2, 1e-2 * abs(lx))
    print(json.dumps({"check": "lm_loss", "fused": round(lf, 5),
                      "xla": round(lx, 5), "diff": round(diff, 6),
                      "ok": ok}), flush=True)
    if not ok:
        raise SystemExit("LM LOSS GATE FAILED")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()
    print(json.dumps({"device": device_record()}), flush=True)

    cfg = TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=4 if args.quick else 8,
        n_heads=16, n_kv_heads=8, d_head=128, d_ff=5632,
    )
    loss_gate(cfg, 1, 512)
    shapes = [(1, 2048)] if args.quick else [(1, 2048), (1, 4096), (2, 4096)]
    for batch, seqlen in shapes:
        for impl in ("fused", "xla"):
            if impl == "xla" and seqlen > 2048:
                # ~[H, N, N] f32 per layer through the backward; keep the
                # baseline where it fits, as bench_attention does (role
                # parity with its N-capped xla arm).
                continue
            bench_one(cfg, batch, seqlen, impl, args.iters)
    # Packed varlen batch (8 docs/row): the segment-masking overhead column.
    bench_one(cfg, *shapes[-1], "fused", args.iters, packed=True)
    if not args.quick:
        import dataclasses

        # Long-context rows (fused only): full causal at 8k, and
        # Mistral-style SWA training — wall-clock should scale with the
        # window past the full-causal crossover, not with N².
        bench_one(cfg, 1, 8192, "fused", args.iters)
        swa = dataclasses.replace(cfg, sliding_window=2048)
        bench_one(swa, 1, 8192, "fused", args.iters)
        # 16k with block remat: the long-context memory lever.
        swa_r = dataclasses.replace(swa, remat=True)
        bench_one(swa_r, 1, 16384, "fused", args.iters)


if __name__ == "__main__":
    main()
