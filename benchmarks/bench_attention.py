"""Attention benchmark sweeps — parity with the reference's bench harnesses.

Mirrors bench_with_sdpa*.py (SURVEY.md §2.2): seqlen sweeps fwd and fwd+bwd,
head-dim scan at N=4096, causal and BNHD variants, with the reference's FLOPs
model (bench_with_sdpa.py:35-41). Baselines filling the SDPA/Triton/CK roles:

  * ``xla``  — softmax(QKᵀ)V in plain XLA, matmuls in the input dtype (the
    "SDPA math backend"),
  * ``cudnn`` — ``jax.nn.dot_product_attention(implementation="cudnn")``,
  * ``jaxfa`` — the Triton-route fused attention that ships with JAX
    (``jax.experimental.pallas.ops.gpu.attention.mha``, a library kernel —
    the reference's Triton/CK role),
  * ``ours`` — flashattn_tpu.flash_attention.

Each result prints as one JSON line; a point that fails (out of memory, a
refused compile) prints its error beside the compiled program's memory.
Run:
  python benchmarks/bench_attention.py [--quick] [--causal] [--mode fwd|fwd_bwd]
  python benchmarks/bench_attention.py --mode fwd_bwd --impls ours,xla \
      --heads 16 --points 4096x256,32768x256     # chosen N x D points only
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
from flashattn_tpu.ops.oracle import attention_reference, attention_xla
from flashattn_tpu.ops.reference import flash_attention_reference
from flashattn_tpu.utils.testing import FWD_TOL, make_qkv
from flashattn_tpu.utils.timing import attention_flops, time_chained_stats

# Shapes above this score-matrix size switch the in-bench oracle from the
# unfused exact softmax (materializes [N, Nk] f32 per head) to the
# O(N)-memory tiled golden model (ops/reference.py) — every row gets a
# non-null maxdiff gate regardless of N.
_ORACLE_MAX_SCORES = 8192 * 8192


def bench_maxdiff(fn, q, k, v, causal, layout, window=None, dtype=None):
    """Forward max-abs diff vs the exact-softmax oracle on (a head-slice
    of) the same inputs — every bench point doubles as an on-chip
    integration test, the reference's practice (bench_with_sdpa.py:140-141;
    SURVEY.md §4.4)."""
    nq_ax = 2 if layout == "BHND" else 1
    big = q.shape[nq_ax] * k.shape[nq_ax] > _ORACLE_MAX_SCORES
    h_ax = 1 if layout == "BHND" else 2
    sl = [slice(None)] * 4
    # 2 heads catch systematic bugs; 1 head for golden-model big-N shapes.
    sl[h_ax] = slice(0, 1 if big else min(2, q.shape[h_ax]))
    qs, ks, vs = q[tuple(sl)], k[tuple(sl)], v[tuple(sl)]
    o = fn(qs, ks, vs, causal, layout)
    if layout == "BNHD":
        qs, ks, vs, o = (x.swapaxes(1, 2) for x in (qs, ks, vs, o))
    qf, kf, vf = (x.astype(jnp.float32) for x in (qs, ks, vs))
    if big:
        w = flash_attention_reference(qf, kf, vf, causal=causal,
                                      window=window,
                                      block_q=512, block_k=1024)
    else:
        w = attention_reference(qf, kf, vf, causal=causal, window=window)
    return float(jnp.max(jnp.abs(o.astype(jnp.float32) - w)))


def peak_memory_bytes(step, *args):
    """Compiled peak memory (temps + args + outputs) — the reference's
    per-point VRAM column (bench_with_sdpa.py:34)."""
    try:
        ma = jax.jit(step).lower(*args).compile().memory_analysis()
        return int(ma.temp_size_in_bytes + ma.argument_size_in_bytes +
                   ma.output_size_in_bytes)
    except Exception:
        return None


def xla_sdpa(q, k, v, causal, layout="BHND"):
    if layout == "BNHD":  # pays the rearrange, like SDPA in the BNHD benches
        q, k, v = (x.swapaxes(1, 2) for x in (q, k, v))
        return attention_xla(q, k, v, causal=causal).swapaxes(1, 2)
    return attention_xla(q, k, v, causal=causal)


def cudnn_sdpa(q, k, v, causal, layout="BHND"):
    if layout == "BHND":
        q, k, v = (x.swapaxes(1, 2) for x in (q, k, v))
    o = jax.nn.dot_product_attention(q, k, v, is_causal=causal,
                                     implementation="cudnn")
    return o.swapaxes(1, 2) if layout == "BHND" else o


def jax_pallas_fa(q, k, v, causal, layout="BHND"):
    """JAX's own Triton-route flash attention (a library kernel), at its
    default block sizes; [B, N, H, D] layout, sequence a block multiple."""
    from jax.experimental.pallas.ops.gpu.attention import mha

    if layout == "BHND":
        q, k, v = (x.swapaxes(1, 2) for x in (q, k, v))
    o = mha(q, k, v, None, sm_scale=q.shape[-1] ** -0.5, causal=causal)
    return o.swapaxes(1, 2) if layout == "BHND" else o


def ours(q, k, v, causal, layout="BHND", window=None):
    return flash_attention(q, k, v, causal=causal, layout=layout,
                           window=window)


IMPLS = {"xla": xla_sdpa, "cudnn": cudnn_sdpa, "jaxfa": jax_pallas_fa,
         "ours": ours}


def bench_one(impl_name, B, H, N, D, *, causal, mode, dtype=jnp.bfloat16,
              iters=32, layout="BHND", window=None):
    fn = IMPLS[impl_name]
    kw = {"window": window} if window is not None else {}
    q, k, v = make_qkv(jax.random.PRNGKey(0), B, H, N, D, dtype=dtype)
    if layout == "BNHD":  # arrays physically stored [B, N, H, D]
        q, k, v = (x.swapaxes(1, 2) for x in (q, k, v))
    if mode == "fwd":
        step = lambda qq, k, v: fn(qq, k, v, causal, layout, **kw)
    else:
        def step(qq, k, v):
            # grads w.r.t. ALL of q,k,v — grad over q alone lets XLA
            # dead-code-eliminate the dK/dV kernel entirely.
            dq, dk, dv = jax.grad(
                lambda x, kk, vv: fn(x, kk, vv, causal, layout, **kw)
                .astype(jnp.float32).sum(),
                argnums=(0, 1, 2),
            )(qq, k, v)
            # 1e-30, not 0.0: XLA may fold 0.0*x and DCE the backward.
            return qq + 1e-30 * dq + (1e-30 * (dk.astype(jnp.float32).sum()
                                               + dv.astype(jnp.float32).sum())
                                      ).astype(qq.dtype)

    mem = peak_memory_bytes(step, q, k, v)
    try:
        stats = time_chained_stats(step, q, consts=(k, v), iters=iters,
                                   warmup_iters=max(2, iters // 4), repeats=5)
        t = stats["per_iter"]
        fwd_only = lambda qq, kk, vv, c, lo: fn(qq, kk, vv, c, lo, **kw)
        maxdiff = bench_maxdiff(fwd_only, q, k, v, causal, layout,
                                window=window)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        print(json.dumps({"impl": impl_name, "B": B, "H": H, "N": N, "D": D,
                          "causal": causal, "mode": mode,
                          "peak_mem_mb": round(mem / 2**20, 1) if mem else None,
                          "error": f"{type(e).__name__}: {str(e)[:160]}"}),
              flush=True)
        return None
    flops = attention_flops(B, H, N, N, D, causal=causal, mode=mode,
                            window=window)
    tflops = flops / t / 1e12
    rec = {
        "impl": impl_name, "B": B, "H": H, "N": N, "D": D,
        "causal": causal, "mode": mode, "dtype": str(jnp.dtype(dtype)),
        "layout": layout,
        "ms": round(t * 1e3, 4), "tflops": round(tflops, 2),
        # dispersion of the 5 timing samples, (max−min)/median — a point
        # whose spread exceeds the claimed improvement is noise
        "spread_pct": round(stats["spread"] * 100, 1),
        "maxdiff": round(maxdiff, 6) if maxdiff is not None else None,
        "peak_mem_mb": round(mem / 2**20, 1) if mem else None,
    }
    if window is not None:
        rec["window"] = list(window)
    print(json.dumps(rec), flush=True)
    tol = FWD_TOL.get(jnp.dtype(dtype))
    if (impl_name == "ours" and maxdiff is not None and tol is not None
            and maxdiff > tol.atol):
        # baselines' maxdiff is recorded but informational; OUR kernel's is
        # a hard on-chip correctness gate (reference practice,
        # bench_with_sdpa.py:140-141)
        raise SystemExit(
            f"BENCH NUMERICS GATE FAILED: {impl_name} {rec} "
            f"maxdiff {maxdiff} > {tol.atol}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--mode", default="fwd", choices=["fwd", "fwd_bwd"])
    ap.add_argument("--impls", default="ours,cudnn,jaxfa,xla")
    ap.add_argument("--layout", default="BHND", choices=["BHND", "BNHD"])
    ap.add_argument("--unaligned", action="store_true",
                    help="non-tile-aligned seqlens (the reference's "
                         "unaligned-N graphs, README.md:72-102)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "float16"])
    ap.add_argument("--window", type=int, default=None,
                    help="left sliding-window size (ours only; causal-style)")
    ap.add_argument("--points", default=None,
                    help="comma list of NxD points to run instead of the "
                         "sweeps, e.g. 16384x256")
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args()

    print(json.dumps({"device": device_record()}), flush=True)
    impls = args.impls.split(",")
    dtype = jnp.dtype(args.dtype)
    B, H = 1, args.heads
    if args.points:
        for point in args.points.split(","):
            N, D = map(int, point.split("x"))
            for impl in impls:
                bench_one(impl, B, H, N, D, causal=args.causal,
                          mode=args.mode, layout=args.layout, dtype=dtype,
                          iters=args.iters)
        return
    if args.quick:
        n_sweep, d_sweep = [1024, 4096], [64, 128]
    else:
        # reference sweeps: fwd N=512..7168, fwd+bwd N=512..5120
        # (bench_with_sdpa.py:112, 201); D scan at N=4096 (:259-260)
        n_sweep = [512, 1024, 2048, 3072, 4096, 5120]
        if args.mode == "fwd":
            # reference tops out at 7168; 8192 extends the long-context story
            n_sweep += [6144, 7168, 8192]
            if args.causal:
                n_sweep += [12288, 16384]
        elif args.causal:
            n_sweep += [8192]  # the LLM-training long-context shape
        # low end 16..48: the SD1.5 cross-attention head class the
        # reference's D-scan explicitly covers (bench_with_sdpa.py:259-283
        # scans 16..240 step 16)
        d_sweep = [16, 32, 48, 64, 80, 128, 160, 256]
    if args.unaligned:
        # precision_test.py-class shapes: N 1 off a tile, odd D
        n_sweep = [n + 1 for n in n_sweep]
        d_sweep = [d - 17 for d in d_sweep if d > 32]

    window = (args.window - 1, 0) if args.window else None
    if window is not None:
        # long-context SWA sweep: cost should scale with the window, not N²
        for N in (4096, 8192, 16384, 32768):
            bench_one("ours", B, H, N, 128, causal=args.causal,
                      mode=args.mode, layout=args.layout, dtype=dtype,
                      window=window)
        return
    for N in n_sweep:
        for impl in impls:
            if impl == "xla" and N > 4096:
                continue  # N² materialization gets slow/huge; matches role
            bench_one(impl, B, H, N, 64, causal=args.causal, mode=args.mode,
                      layout=args.layout, dtype=dtype, iters=args.iters)
    for D in d_sweep:
        for impl in impls:
            bench_one(impl, B, H, 4096, D, causal=args.causal, mode=args.mode,
                      layout=args.layout, dtype=dtype, iters=args.iters)
    if args.causal and not args.unaligned and dtype == jnp.bfloat16:
        # Long-context rows at the LLM head dim D=128 (the N sweep above is
        # D=64 for reference parity, bench_with_sdpa.py:52).
        longn = ((8192, 12288, 16384) if args.mode == "fwd"
                 else (8192, 16384))
        for N in longn:
            bench_one("ours", B, H, N, 128, causal=True, mode=args.mode,
                      layout=args.layout, dtype=dtype)


if __name__ == "__main__":
    main()
