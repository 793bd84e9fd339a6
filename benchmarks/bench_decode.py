"""LLM decode benchmark: autoregressive tokens/s + quantized-KV attention.

The serving-side counterpart of the SD bench (the north star adds an "LLM
decode path" beyond the reference). Two measurements:

  1. end-to-end decode_step tokens/s for a Llama-class config at several
     cache lengths (attention is Nq=1 vs the filled prefix);
  2. decode-shape attention kernel: bf16 KV vs int8/fp8 in-kernel-dequant KV
     (flash_attention_quantized) — the HBM-bandwidth story, since decode
     attention is bandwidth-bound in the KV cache reads.

  python benchmarks/bench_decode.py [--quick]
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

from flashattn_tpu import flash_attention
from flashattn_tpu.models.transformer import (
    TransformerConfig, decode_step, init_kv_cache, init_transformer,
)
from flashattn_tpu.ops.quant import flash_attention_quantized, quantize_kv
from flashattn_tpu.utils.timing import time_chained


def bench_decode_tokens_per_s(cfg, batch, cache_len, iters):
    params = jax.jit(lambda k: init_transformer(k, cfg))(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    cache = init_kv_cache(cfg, batch, cache_len)
    # pre-fill half the cache so attention reads a realistic prefix
    cache["length"] = jnp.asarray(cache_len // 2, jnp.int32)
    tok0 = jnp.zeros((batch,), jnp.int32)

    def step(carry, params):
        tok, cache = carry
        logits, cache = decode_step(params, cache, tok, cfg)
        # keep cache length fixed so the chained iterations are homogeneous
        cache = dict(cache, length=cache["length"] - 1)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache

    t = time_chained(step, (tok0, cache), consts=(params,), iters=iters,
                     warmup_iters=max(2, iters // 4), repeats=2)
    rec = {
        "bench": "decode", "batch": batch, "cache_len": cache_len,
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "tokens_per_s": round(batch / t, 1), "ms_per_token": round(t * 1e3, 3),
    }
    print(json.dumps(rec), flush=True)
    return rec


def bench_quantized_attn(B, H, nk, D, iters, kv_dtype, *, hkv=None, nq=1):
    """Decode-shape fused attention: ``nq`` query rows against a long KV
    cache. ``hkv`` < H benches the GQA cache (the memory-bound config class
    real serving runs — the cache is Hkv-wide, so the bandwidth floor drops
    by H/Hkv); ``nq`` in {4, 16} is the speculative/multi-query row."""
    hkv = H if hkv is None else hkv
    kq, kk, kv2 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(kq, (B, H, nq, D), jnp.bfloat16)
    k = jax.random.normal(kk, (B, hkv, nk, D), jnp.bfloat16)
    v = jax.random.normal(kv2, (B, hkv, nk, D), jnp.bfloat16)

    if kv_dtype == "bf16":
        step = lambda qq, k, v: qq + 1e-30 * flash_attention(qq, k, v)
        consts = (k, v)
    else:
        qkv = quantize_kv(k, v, jnp.int8 if kv_dtype == "int8"
                          else jnp.float8_e4m3fn)
        step = lambda qq, qkv: qq + 1e-30 * flash_attention_quantized(qq, qkv)
        consts = (qkv,)

    t = time_chained(step, q, consts=consts, iters=iters,
                     warmup_iters=max(2, iters // 4), repeats=2)
    kv_bytes = 2 * B * hkv * nk * D * (2 if kv_dtype == "bf16" else 1)
    rec = {
        "bench": "decode_attn", "kv_dtype": kv_dtype,
        "B": B, "H": H, "nk": nk, "D": D,
        **({"Hkv": hkv} if hkv != H else {}),
        **({"Nq": nq} if nq != 1 else {}),
        "us": round(t * 1e6, 2),
        "kv_read_gbps": round(kv_bytes / t / 1e9, 1),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args()
    print(json.dumps({"device": device_record()}), flush=True)

    cfg = TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=4 if args.quick else 16,
        n_heads=16, n_kv_heads=8, d_head=128, d_ff=5632,
    )
    cache_lens = [1024] if args.quick else [1024, 4096, 8192]
    for cl in cache_lens:
        bench_decode_tokens_per_s(cfg, batch=8, cache_len=cl,
                                  iters=args.iters)

    nks = [8192] if args.quick else [4096, 8192, 16384, 32768]
    for nk in nks:
        for kv_dtype in ("bf16", "int8", "fp8"):
            bench_quantized_attn(8, 16, nk, 128, args.iters, kv_dtype)

    # GQA decode (Hkv < H — the production serving cache layout) and
    # speculative multi-query rows (VERDICT r3 #9).
    gqa_nks = [8192] if args.quick else [8192, 32768]
    for nk in gqa_nks:
        for hkv in (4, 2):
            for kv_dtype in ("bf16", "int8"):
                bench_quantized_attn(8, 16, nk, 128, args.iters, kv_dtype,
                                     hkv=hkv)
        for nq in (4, 16):
            bench_quantized_attn(8, 16, nk, 128, args.iters, "bf16", nq=nq)


if __name__ == "__main__":
    main()
