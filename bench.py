"""Headline benchmark — prints the device, then ONE JSON result line.

Metric: fused attention forward TFLOP/s at the reference's kernel-bench shape
class (B=1, H=24, N=4096 — bench_with_sdpa.py:52, 112) with D=128, bf16,
non-causal. ``vs_baseline`` is the speedup over plain XLA attention (matmuls
in bf16, the reference's own primary comparison: its kernel vs the SDPA math
backend, bench_with_sdpa.py:5-7, 66-69).

FLOPs model: fwd = 2 · (2·B·H·N²·D), the reference's accounting
(bench_with_sdpa.py:35-41). Needs a GPU: on any other backend it exits
without a number.
"""

import json
import sys

import jax
import jax.numpy as jnp

from flashattn_tpu.utils.platform import device_record, enable_compilation_cache


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU (backend {jax.default_backend()!r})")
    enable_compilation_cache()
    from flashattn_tpu import flash_attention
    from flashattn_tpu.ops.oracle import attention_reference, attention_xla
    from flashattn_tpu.utils.testing import make_qkv
    from flashattn_tpu.utils.timing import attention_flops, time_chained

    device = device_record()
    print(json.dumps({"device": device}), flush=True)
    B, H, N, D = 1, 24, 4096, 128
    q, k, v = make_qkv(jax.random.PRNGKey(0), B, H, N, D, dtype=jnp.bfloat16)
    flops = attention_flops(B, H, N, N, D, causal=False, mode="fwd")

    # Numerics gate: the bench is also an on-chip integration test (the
    # reference prints max diff before TFLOPS, bench_with_sdpa.py:140-141).
    o = flash_attention(q, k, v)
    w = attention_reference(*(x.astype(jnp.float32) for x in (q, k, v)))
    maxdiff = float(jnp.max(jnp.abs(o.astype(jnp.float32) - w)))
    if maxdiff > 2e-2:
        raise SystemExit(f"BENCH NUMERICS GATE FAILED: maxdiff={maxdiff}")

    t_ours = time_chained(lambda qq, k, v: flash_attention(qq, k, v), q,
                          consts=(k, v), iters=32, warmup_iters=4, repeats=3)
    t_xla = time_chained(lambda qq, k, v: attention_xla(qq, k, v), q,
                         consts=(k, v), iters=16, warmup_iters=4, repeats=3)
    print(json.dumps({
        "metric": "fused_attn_fwd_bf16_B1H24N4096D128_tflops",
        "value": round(flops / t_ours / 1e12, 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(t_xla / t_ours, 3),
        "maxdiff": maxdiff,
        "device": device,
    }))


if __name__ == "__main__":
    main()
