"""Stable-Diffusion end-to-end it/s benchmark — the reference's headline metric.

Parity target: the reference's ComfyUI tables (README.md:104-154, rows in
BASELINE.md): SD1.5 at 512²×1, 512²×4, 1024²×1 and SDXL at 1024²×1, each as
it/s (one "it" = one U-Net denoise step, Euler sampler) for the fused engine
vs exact-softmax XLA attention (the "PyTorch SDPA math backend" role), plus
peak device memory per step (the VRAM columns) from XLA's compiled memory
analysis.

Run (on the GPU):  python benchmarks/bench_diffusion.py [--quick]
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

from flashattn_tpu.models.unet import UNetConfig, init_unet, unet_forward
from flashattn_tpu.utils.platform import device_record, enable_compilation_cache
from flashattn_tpu.utils.timing import time_chained

enable_compilation_cache()


# (name, cfg-factory, latent HW, batch) — latent = pixel/8 (SD VAE factor)
WORKLOADS = [
    ("sd15_512x512_b1", UNetConfig.sd15, 64, 1),
    ("sd15_512x512_b4", UNetConfig.sd15, 64, 4),
    ("sd15_1024x1024_b1", UNetConfig.sd15, 128, 1),
    ("sdxl_1024x1024_b1", UNetConfig.sdxl, 128, 1),
]


def _lora_paths(params, prefix=()):
    """Paths of the attention projection matrices (wq/wk/wv/wo  →  "w")."""
    if isinstance(params, dict):
        for kk, vv in params.items():
            yield from _lora_paths(vv, prefix + (kk,))
    elif isinstance(params, (list, tuple)):
        for i, vv in enumerate(params):
            yield from _lora_paths(vv, prefix + (i,))
    else:
        if (len(prefix) >= 2 and prefix[-1] == "w"
                and prefix[-2] in ("wq", "wk", "wv", "wo")):
            yield prefix, params


def init_lora(key, params, rank=32):
    """Rank-``rank`` adapters on every attention projection: A ~ N(0, 1/r),
    B = 0 (standard LoRA init — the delta starts at zero). Matches the
    reference's trained-module choice (attention processors) and dim/alpha 32
    config (README.md:136-149)."""
    lora = {}
    for path, w in _lora_paths(params):
        key, sub = jax.random.split(key)
        cin, cout = w.shape
        lora["/".join(map(str, path))] = {
            "a": (jax.random.normal(sub, (cin, rank), jnp.float32)
                  / rank).astype(w.dtype),
            "b": jnp.zeros((rank, cout), w.dtype),
        }
    return lora


def apply_lora(params, lora, scale=1.0):
    """Functional ``W' = W + scale·A@B`` on the adapted leaves."""
    def patch(node, prefix=()):
        if isinstance(node, dict):
            return {kk: patch(vv, prefix + (kk,)) for kk, vv in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(patch(vv, prefix + (i,))
                              for i, vv in enumerate(node))
        key = "/".join(map(str, prefix))
        if key in lora:
            ab = lora[key]
            delta = (ab["a"].astype(jnp.float32)
                     @ ab["b"].astype(jnp.float32)) * scale
            return (node.astype(jnp.float32) + delta).astype(node.dtype)
        return node

    return patch(params)


def build_step(params, cfg, latent_hw, batch, attn_impl, mode="sample"):
    """``mode="sample"``: one Euler denoise step at a fixed mid-schedule sigma
    (one ComfyUI "it"). ``mode="train"``: one full-parameter training step
    (eps-MSE loss, grads through every attention backward). ``mode=
    "train_lora"``: base frozen, grads w.r.t. rank-32 attention adapters
    only — like-for-like with the reference's SDXL LoRA row
    (README.md:134-154, AdamW dim/alpha 32). Each is a chainable
    latent→latent map."""
    ctx_len = 77
    context = jax.random.normal(
        jax.random.PRNGKey(2), (batch, ctx_len, cfg.context_dim), jnp.float32)
    sigma, sigma_next = 5.0, 4.5
    c_in = (sigma**2 + 1.0) ** -0.5
    t = jnp.full((batch,), 500.0)

    # params/context are jit ARGUMENTS (consts), never closure constants:
    # closure arrays would be embedded into the compiled program.
    if mode == "sample":
        def step(x, params, context):
            eps = unet_forward(params, x * c_in, t, context, cfg,
                               attn_impl=attn_impl)
            return x + (sigma_next - sigma) * eps.astype(x.dtype)
    elif mode == "train_lora":
        lora0 = jax.jit(lambda k, p: init_lora(k, p))(
            jax.random.PRNGKey(3), params)
        jax.block_until_ready(lora0)

        def step(x, params, context, lora):
            def loss_fn(lp):
                p = apply_lora(params, lp)
                eps = unet_forward(p, x * c_in, t, context, cfg,
                                   attn_impl=attn_impl)
                return jnp.mean((eps.astype(jnp.float32)
                                 - x.astype(jnp.float32)) ** 2)

            g = jax.grad(loss_fn)(lora)
            gs = sum(jnp.sum(l.astype(jnp.float32))
                     for l in jax.tree_util.tree_leaves(g))
            return x + (1e-30 * gs).astype(x.dtype)
    else:
        def step(x, params, context):
            def loss_fn(p):
                eps = unet_forward(p, x * c_in, t, context, cfg,
                                   attn_impl=attn_impl)
                return jnp.mean((eps.astype(jnp.float32)
                                 - x.astype(jnp.float32)) ** 2)

            g = jax.grad(loss_fn)(params)
            gs = sum(jnp.sum(l.astype(jnp.float32))
                     for l in jax.tree_util.tree_leaves(g))
            # 1e-30, not 0.0: XLA may fold 0.0*x and DCE the backward.
            return x + (1e-30 * gs).astype(x.dtype)

    x0 = jax.random.normal(
        jax.random.PRNGKey(1), (batch, latent_hw, latent_hw, cfg.in_channels),
        jnp.float32) * sigma
    consts = ((params, context, lora0) if mode == "train_lora"
              else (params, context))
    return step, x0, consts


def peak_memory_bytes(step, x0, *consts):
    """Peak device memory of the compiled step (the VRAM-column analogue)."""
    try:
        compiled = jax.jit(step).lower(x0, *consts).compile()
        ma = compiled.memory_analysis()
        return int(ma.temp_size_in_bytes + ma.argument_size_in_bytes +
                   ma.output_size_in_bytes)
    except Exception:
        return None


def bench_one(name, cfg_factory, latent_hw, batch, impls, iters,
              mode="sample"):
    cfg = cfg_factory()
    # jit the whole init: one program instead of one dispatch per parameter
    params = jax.jit(lambda k: init_unet(k, cfg))(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    print(json.dumps({"workload": name, "status": "params_ready"}),
          flush=True)
    results = {}
    for impl in impls:
        step, x0, consts = build_step(params, cfg, latent_hw, batch, impl,
                                      mode)
        mem = peak_memory_bytes(step, x0, *consts)
        try:
            t = time_chained(step, x0, consts=consts, iters=iters,
                             warmup_iters=max(2, iters // 4), repeats=2)
        except Exception as e:  # noqa: BLE001 — OOM on xla@1024² is a result
            print(json.dumps({"workload": name, "impl": impl,
                              "error": type(e).__name__}), flush=True)
            continue
        rec = {
            "workload": name, "impl": impl, "mode": mode,
            "it_per_s": round(1.0 / t, 3), "ms_per_it": round(t * 1e3, 2),
            "peak_mem_gb": round(mem / 2**30, 3) if mem else None,
        }
        results[impl] = rec
        print(json.dumps(rec), flush=True)
    if "fused" in results and "xla" in results:
        up = results["xla"]["ms_per_it"] / results["fused"]["ms_per_it"] - 1.0
        print(json.dumps({"workload": name,
                          "fused_vs_xla_uplift_pct": round(100 * up, 1)}),
              flush=True)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--impls", default="fused,xla")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--mode", default="sample",
                    choices=["sample", "train", "train_lora"])
    args = ap.parse_args()
    print(json.dumps({"device": device_record()}), flush=True)
    impls = args.impls.split(",")
    if args.mode == "train":
        # full-param training rows: SD1.5 512² + SDXL 1024²
        loads = [WORKLOADS[0], WORKLOADS[3]]
    elif args.mode == "train_lora":
        # the reference's actual training row is SDXL *LoRA* 1024²
        # (README.md:134-154) — like-for-like comparison
        loads = [WORKLOADS[3]]
    else:
        loads = WORKLOADS
    if args.quick:
        loads = loads[:1]
    for name, cfg_factory, hw, batch in loads:
        bench_one(name, cfg_factory, hw, batch, impls, args.iters,
                  args.mode)


if __name__ == "__main__":
    main()
