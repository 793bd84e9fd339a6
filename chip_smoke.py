#!/usr/bin/env python3
"""End-to-end check of the attention engine on one NVIDIA GPU.

Runs the main path through the entry points a user calls, in one process
(a JAX process reserves most of the card's memory):

  kernels  every forward/backward kernel regime against the f32 oracle at
           real widths (with ``--timing``, its time beside plain XLA and
           cuDNN: those extra compiles would not fit the default run's
           time limit);
  lm       the LM (d_model 2048, 8 layers, 16/8 heads, d_head 128): the
           fused-vs-XLA loss gate, 5 AdamW steps at 4096 tokens, a packed
           step, and 16 decode tokens against a 4096-token cache with bf16
           and int8 KV;
  unet     the SD1.5 U-Net at 512² (latent 64×64): 4 Euler steps fused and
           with XLA attention, latents compared;
  tests    the ``gpu``-marked tests, in this process.

    python chip_smoke.py                 # all phases, one card
    python chip_smoke.py --multichip     # sharded LM step on 4 cards only
    python chip_smoke.py --phases kernels --timing   # + kernel/XLA/cuDNN times

Weights and inputs are random, from ``--seed``. Exits non-zero if JAX finds
no GPU or any check fails. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LATENT = 64     # SD1.5 latent side at 512² pixels
LM_TOKENS = 4096
SHARDED_TOKENS = 16384


def log(*a):
    print(*a, flush=True)


class Checks:
    """Collects pass/fail of every check; any failure fails the run."""

    def __init__(self):
        self.failed = []

    def expect(self, ok, what):
        log(("PASS " if ok else "FAIL ") + what)
        if not ok:
            self.failed.append(what)


def timed(fn, *args, min_seconds=0.2):
    """Mean seconds per call of a compiled ``fn`` after one warm-up call,
    each window ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    one = max(time.perf_counter() - t0, 1e-6)
    n = max(3, min(100, int(min_seconds / one)))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


# ─────────────────────────────── kernels ────────────────────────────────────


def kernel_regimes():
    """(name, B, Hq, Hkv, Nq, Nk, D, dtype, options) per regime."""
    import jax.numpy as jnp

    bf, f16, f32 = jnp.bfloat16, jnp.float16, jnp.float32
    return [
        ("noncausal", 1, 24, 24, 4096, 4096, 128, bf, {}),
        ("causal_gqa", 1, 16, 8, 8192, 8192, 128, bf, {"causal": True}),
        ("causal_window", 1, 16, 8, 8192, 8192, 128, bf,
         {"causal": True, "window": (2047, 0)}),
        ("unet_self_d40", 2, 8, 8, 4096, 4096, 40, bf, {}),
        ("unet_cross_d40", 2, 8, 8, 4096, 77, 40, bf, {}),
        ("d64", 1, 16, 16, 4096, 4096, 64, bf, {}),
        ("d256", 1, 16, 16, 4096, 4096, 256, bf, {}),
        ("unaligned_adversarial", 3, 7, 7, 1537, 1234, 111, bf, {}),
        ("unaligned_4097", 1, 16, 16, 4097, 4097, 64, bf, {}),
        ("bias_dbias", 1, 8, 8, 2048, 2048, 64, bf, {"bias": (1, 1)}),
        ("segments8_causal", 1, 16, 8, 8192, 8192, 128, bf,
         {"causal": True, "segments": 8}),
        ("softcap50_causal", 1, 16, 16, 4096, 4096, 128, bf,
         {"causal": True, "logit_softcap": 50.0}),
        ("fp16", 1, 16, 16, 2048, 2048, 128, f16, {}),
        ("f32", 1, 16, 16, 2048, 2048, 128, f32, {}),
        ("with_lse_traced_offsets", 1, 16, 16, 4096, 4096, 128, bf,
         {"causal": True, "lse_offsets": (2048, 0)}),
        ("decode_bf16", 8, 32, 8, 1, 32768, 128, bf, {"decode": None}),
        ("decode_int8", 8, 32, 8, 1, 32768, 128, bf, {"decode": "int8"}),
        ("decode_fp8", 8, 32, 8, 1, 32768, 128, bf, {"decode": "fp8"}),
    ]


def _cudnn_attention(q, k, v, bias, opts):
    """cuDNN fused attention through ``jax.nn.dot_product_attention``
    (BNHD layout); raises where cuDNN does not take the regime."""
    import jax
    import jax.numpy as jnp

    if "segments" in opts or "logit_softcap" in opts:
        raise NotImplementedError("no segment ids / soft-cap in this API")
    window = opts.get("window")
    out = jax.nn.dot_product_attention(
        *(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), bias=bias,
        is_causal=opts.get("causal", False),
        local_window_size=window, implementation="cudnn")
    return jnp.swapaxes(out, 1, 2)


def run_kernels(checks, seed, timing, rows):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu import flash_attention, flash_attention_with_lse
    from flashattn_tpu.ops.oracle import (
        attention_reference, attention_reference_with_lse, attention_xla)
    from flashattn_tpu.ops.quant import (
        dequantize_kv, flash_attention_quantized, quantize_kv)
    from flashattn_tpu.utils.testing import BWD_TOL, FWD_TOL, check_close

    key = jax.random.PRNGKey(seed)
    for name, B, Hq, Hkv, Nq, Nk, D, dtype, opts in kernel_regimes():
        key, kq, kk, kv, kb, kc = jax.random.split(key, 6)
        q = jax.random.normal(kq, (B, Hq, Nq, D), jnp.float32).astype(dtype)
        k = jax.random.normal(kk, (B, Hkv, Nk, D), jnp.float32).astype(dtype)
        v = jax.random.normal(kv, (B, Hkv, Nk, D), jnp.float32).astype(dtype)
        kw = {x: opts[x] for x in ("causal", "window", "logit_softcap")
              if x in opts}
        bias = None
        if "bias" in opts:
            bias = 0.5 * jax.random.normal(kb, (*opts["bias"], Nq, Nk))
        seg = None
        if "segments" in opts:
            cuts = np.sort(np.random.default_rng(seed).choice(
                np.arange(1, Nq), opts["segments"] - 1, replace=False))
            seg = jnp.asarray(np.searchsorted(cuts, np.arange(Nq),
                                              side="right")[None],
                              jnp.int32).repeat(B, 0)
        f32 = lambda x: None if x is None else x.astype(jnp.float32)  # noqa
        ref_kw = dict(kw, bias=bias,
                      segment_ids=None if seg is None else (seg, seg))
        fwd_tol, bwd_tol = FWD_TOL[jnp.dtype(dtype)], BWD_TOL[jnp.dtype(dtype)]
        row = {"regime": name, "shape": f"{B}x{Hq}/{Hkv}x{Nq}->{Nk}x{D}",
               "dtype": jnp.dtype(dtype).name}

        if "decode" in opts:
            kind = opts["decode"]
            if kind is None:
                fused = jax.jit(lambda q, k, v: flash_attention(q, k, v))
                args = (q, k, v)
                kd, vd = k, v
            else:
                qkv = quantize_kv(k, v, jnp.int8 if kind == "int8"
                                  else jnp.float8_e4m3fn)
                fused = jax.jit(flash_attention_quantized)
                args = (q, qkv)
                kd, vd = dequantize_kv(qkv, jnp.float32)
            want = attention_reference(f32(q), f32(kd), f32(vd))
            got = fused(*args)
            ok, msg = check_close(got, want, fwd_tol, "o")
            checks.expect(ok, f"kernel {name} fwd: {msg}")
            if timing:
                row["kernel_fwd_ms"] = timed(fused, *args) * 1e3
                xla = jax.jit(lambda q, k, v: attention_xla(q, k, v))
                row["xla_fwd_ms"] = timed(xla, q, kd.astype(dtype),
                                          vd.astype(dtype)) * 1e3
            rows.append(row)
            log(json.dumps(row))
            continue

        if "lse_offsets" in opts:
            qo, ko = opts["lse_offsets"]

            def fused(q, k, v, qo, ko):
                return flash_attention_with_lse(q, k, v, causal=True,
                                                q_offset=qo, kv_offset=ko)

            fused = jax.jit(fused)
            offs = (jnp.int32(qo), jnp.int32(ko))
            o, lse = fused(q, k, v, *offs)
            want, lse_want = attention_reference_with_lse(
                f32(q), f32(k), f32(v), causal=True, q_offset=qo,
                kv_offset=ko)
            ok, msg = check_close(o, want, fwd_tol, "o")
            checks.expect(ok, f"kernel {name} fwd: {msg}")
            ok, msg = check_close(lse, lse_want, FWD_TOL[jnp.dtype("float32")],
                                  "lse")
            checks.expect(ok, f"kernel {name} lse: {msg}")
            if timing:
                row["kernel_fwd_ms"] = timed(fused, q, k, v, *offs) * 1e3
            rows.append(row)
            log(json.dumps(row))
            continue

        ct = jax.random.normal(kc, (B, Hq, Nq, D), jnp.float32)
        argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)

        def loss(attn, cast):
            def f(q, k, v, bias):
                o = attn(cast(q), cast(k), cast(v), **dict(ref_kw, bias=bias))
                return jnp.sum(o.astype(jnp.float32) * ct)
            return f

        fused_fwd = jax.jit(lambda q, k, v, b: flash_attention(
            q, k, v, **dict(ref_kw, bias=b)))
        fused_step = jax.jit(jax.grad(loss(flash_attention, lambda x: x),
                                      argnums))
        compiled = fused_step.lower(q, k, v, bias).compile()
        mem = compiled.memory_analysis()
        if mem is not None:
            row["fwd_bwd_temp_mb"] = mem.temp_size_in_bytes / 2**20
        got = fused_fwd(q, k, v, bias)
        want = attention_reference(f32(q), f32(k), f32(v), **ref_kw)
        ok, msg = check_close(got, want, fwd_tol, "o")
        row["fwd_maxabs"] = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                                  - want)))
        checks.expect(ok, f"kernel {name} fwd: {msg}")
        grads = compiled(q, k, v, bias)
        grads_want = jax.jit(jax.grad(loss(attention_reference, f32),
                                      argnums))(q, k, v, bias)
        for gname, g, gw in zip(("dq", "dk", "dv", "dbias"), grads,
                                grads_want):
            ok, msg = check_close(g, gw, bwd_tol, gname)
            row[f"{gname}_maxabs"] = float(jnp.max(jnp.abs(
                g.astype(jnp.float32) - gw)))
            checks.expect(ok, f"kernel {name} {gname}: {msg}")
        del grads, grads_want, want
        if timing:
            row["kernel_fwd_ms"] = timed(fused_fwd, q, k, v, bias) * 1e3
            row["kernel_fwd_bwd_ms"] = timed(compiled, q, k, v, bias) * 1e3
            xla_kw = dict(ref_kw)
            xla_fwd = jax.jit(lambda q, k, v, b: attention_xla(
                q, k, v, **dict(xla_kw, bias=b)))
            xla_step = jax.jit(jax.grad(loss(attention_xla, lambda x: x),
                                        argnums))
            row["xla_fwd_ms"] = timed(xla_fwd, q, k, v, bias) * 1e3
            row["xla_fwd_bwd_ms"] = timed(xla_step, q, k, v, bias) * 1e3
            try:
                cud_fwd = jax.jit(lambda q, k, v, b: _cudnn_attention(
                    q, k, v, b, opts))
                cud_step = jax.jit(jax.grad(
                    lambda q, k, v, b: jnp.sum(_cudnn_attention(
                        q, k, v, b, opts).astype(jnp.float32) * ct),
                    argnums))
                row["cudnn_fwd_ms"] = timed(cud_fwd, q, k, v, bias) * 1e3
                row["cudnn_fwd_bwd_ms"] = timed(cud_step, q, k, v,
                                                bias) * 1e3
            except Exception as e:  # cuDNN does not take every regime
                row["cudnn"] = f"not supported: {type(e).__name__}"
        rows.append(row)
        log(json.dumps(row))


# ───────────────────────────────── LM ───────────────────────────────────────


def lm_config():
    from flashattn_tpu.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32000, d_model=2048, n_layers=8,
                             n_heads=16, n_kv_heads=8, d_head=128, d_ff=5632)


def run_lm(checks, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu.models.transformer import (
        adamw_init, adamw_update, decode_step, init_kv_cache,
        init_transformer, lm_loss)

    cfg = lm_config()
    params = jax.jit(lambda k: init_transformer(k, cfg))(
        jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(seed + 1)

    # Loss gate: fused attention against XLA attention, 512 tokens.
    toks = jax.random.randint(key, (1, 513), 0, cfg.vocab_size)
    lf = float(jax.jit(lambda p, t: lm_loss(p, t, cfg))(params, toks))
    lx = float(jax.jit(lambda p, t: lm_loss(p, t, cfg, attn_impl="xla"))(
        params, toks))
    checks.expect(abs(lf - lx) < max(5e-2, 1e-2 * abs(lx)),
                  f"lm loss gate: fused {lf:.5f} xla {lx:.5f}")

    @jax.jit
    def train_step(params, opt, tokens, seg=None):
        loss, g = jax.value_and_grad(
            lambda p: lm_loss(p, tokens, cfg, segment_ids=seg))(params)
        params, opt = adamw_update(g, opt, params, lr=3e-4)
        return params, opt, loss

    toks = jax.random.randint(key, (1, LM_TOKENS + 1), 0, cfg.vocab_size)
    opt = adamw_init(params)
    p, losses = params, []
    t0 = time.perf_counter()
    for _ in range(5):
        p, opt, loss = train_step(p, opt, toks)
        losses.append(float(loss))
    log(json.dumps({"lm_train_losses": losses,
                    "seconds_incl_compile": time.perf_counter() - t0}))
    checks.expect(all(np.isfinite(losses)) and losses[-1] < losses[0],
                  f"lm 5 AdamW steps at {LM_TOKENS} tokens: {losses}")
    cuts = np.sort(np.random.default_rng(seed).choice(
        np.arange(1, LM_TOKENS + 1), 7, replace=False))
    seg = jnp.asarray(np.searchsorted(cuts, np.arange(LM_TOKENS + 1),
                                      side="right")[None], jnp.int32)
    _, _, loss = train_step(p, opt, toks, seg)
    checks.expect(bool(np.isfinite(float(loss))),
                  f"lm packed step (8 docs): loss {float(loss):.5f}")
    del opt, p

    for quant in (None, jnp.int8):
        cache = init_kv_cache(cfg, 1, LM_TOKENS + 16, quant_dtype=quant)
        cache["length"] = jnp.asarray(LM_TOKENS, jnp.int32)
        step = jax.jit(lambda p, c, t: decode_step(p, c, t, cfg))
        tok = jnp.zeros((1,), jnp.int32)
        out = []
        for _ in range(16):
            logits, cache = step(params, cache, tok)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out.append(int(tok[0]))
        finite = bool(jnp.all(jnp.isfinite(logits)))
        name = "bf16" if quant is None else "int8"
        checks.expect(finite and len(out) == 16,
                      f"lm decode 16 tokens, {name} KV at {LM_TOKENS}: "
                      f"{out}")


# ──────────────────────────────── U-Net ─────────────────────────────────────


def run_unet(checks, seed):
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.diffusion import euler_sample
    from flashattn_tpu.models.unet import UNetConfig, init_unet

    # zero_init=False: SD zero-initializes the attention blocks' output
    # projections, which would hide attention from the comparison.
    cfg = dataclasses.replace(UNetConfig.sd15(), zero_init=False)
    # Eager init: jitting the whole SD1.5 init compiled for minutes.
    params = init_unet(jax.random.PRNGKey(seed), cfg)
    ctx = jax.random.normal(jax.random.PRNGKey(seed + 1), (1, 77, 768),
                            jnp.bfloat16)
    key = jax.random.PRNGKey(seed + 2)
    lat = {}
    for impl in ("fused", "xla"):
        t0 = time.perf_counter()
        x = euler_sample(params, key, ctx, cfg=cfg,
                         shape=(1, LATENT, LATENT, 4),
                         steps=4, attn_impl=impl)
        lat[impl] = x.astype(jnp.float32)
        log(json.dumps({"unet": impl, "seconds_incl_compile":
                        time.perf_counter() - t0}))
    diff = float(jnp.max(jnp.abs(lat["fused"] - lat["xla"])))
    scale = float(jnp.max(jnp.abs(lat["xla"])))
    # The XLA path computes attention in f32, the kernel rounds P to bf16
    # (2^-8 relative); through 16 transformer blocks and 4 steps of bf16
    # activations that compounds to 0.64% of the latent maximum on an H100
    # (0.458 of 71.8 at this seed). The bound is twice that. A difference
    # of exactly 0 means the two runs did not differ in attention at all
    # (as with SD's zero-initialized attention output projections).
    bound = 1.3e-2 * max(scale, 1.0)
    checks.expect(bool(jnp.all(jnp.isfinite(lat["fused"])))
                  and 0.0 < diff < bound,
                  f"unet sd15 4 Euler steps: max|fused-xla| {diff:.4g} "
                  f"(latent max {scale:.4g}, bound 0 < diff < {bound:.4g})")


# ────────────────────────────── multichip ───────────────────────────────────


def run_multichip(checks, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu import flash_attention
    from flashattn_tpu.models.transformer import (
        adamw_init, init_transformer, make_sharded_train_step)
    from flashattn_tpu.parallel import make_mesh
    from flashattn_tpu.parallel.ulysses import ulysses_attention_sharded
    from flashattn_tpu.utils.testing import BWD_TOL, FWD_TOL, check_close

    # LM widths at one layer (depth cut: sharding acts on every layer alike,
    # and four cards' time is scarce).
    cfg = dataclasses.replace(lm_config(), n_layers=1)
    params = jax.jit(lambda k: init_transformer(k, cfg))(
        jax.random.PRNGKey(seed))
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1),
                              (1, SHARDED_TOKENS), 0, cfg.vocab_size)

    def two_steps(mesh, **kw):
        """Losses of two sharded steps, the update norm after them, and the
        devices holding the shards of one weight."""
        step, _, _ = make_sharded_train_step(mesh, cfg, lr=3e-4, **kw)
        p, opt, loss = step(params, adamw_init(params), toks)
        p, opt, loss2 = step(p, opt, toks)
        sq = [jnp.sum((a.astype(jnp.float32) - b.astype(jnp.float32)) ** 2)
              for a, b in zip(jax.tree_util.tree_leaves(p),
                              jax.tree_util.tree_leaves(params))]
        leaf = p["layers"][0]["wq"]
        where = sorted({str(s.device) for s in leaf.addressable_shards})
        return float(loss), float(loss2), float(jnp.sqrt(sum(sq))), where

    base = two_steps(make_mesh(1, 1, 1))
    log(json.dumps({"mesh": "1x1x1", "losses": base[:2],
                    "update_norm": base[2], "devices": base[3]}))
    for shape, kw in (((1, 2, 2), {}), ((1, 1, 4), {"seq_layout": "zigzag"})):
        got = two_steps(make_mesh(*shape), **kw)
        log(json.dumps({"mesh": "x".join(map(str, shape)), **kw,
                        "losses": got[:2], "update_norm": got[2],
                        "devices": got[3]}))
        checks.expect(
            abs(got[0] - base[0]) < 2e-2 and abs(got[1] - base[1]) < 5e-2
            and abs(got[2] - base[2]) < 2e-2 * base[2]
            and len(got[3]) == int(np.prod(shape)),
            f"multichip {shape} {kw}: losses {got[0]:.5f}/{got[1]:.5f} vs "
            f"one card {base[0]:.5f}/{base[1]:.5f}; update norm "
            f"{got[2]:.5f} vs {base[2]:.5f}; shards on {got[3]}")

    # Ulysses all-to-all SP at the LM's attention widths, against one card.
    key = jax.random.split(jax.random.PRNGKey(seed + 2), 4)
    n, d = SHARDED_TOKENS, cfg.d_head
    q = jax.random.normal(key[0], (1, cfg.n_heads, n, d), jnp.bfloat16)
    k = jax.random.normal(key[1], (1, cfg.n_kv_heads, n, d), jnp.bfloat16)
    v = jax.random.normal(key[2], (1, cfg.n_kv_heads, n, d), jnp.bfloat16)
    ct = jax.random.normal(key[3], q.shape, jnp.float32)
    uly = ulysses_attention_sharded(make_mesh(1, 1, 4), causal=True)

    def out_and_grads(attn):
        def f(q, k, v):
            o = attn(q, k, v)
            return jnp.sum(o.astype(jnp.float32) * ct), o
        return jax.jit(jax.grad(f, (0, 1, 2), has_aux=True))

    g1, o1 = out_and_grads(
        lambda q, k, v: flash_attention(q, k, v, causal=True))(q, k, v)
    g4, o4 = out_and_grads(uly)(q, k, v)
    where = sorted({str(s.device) for s in o4.addressable_shards})
    ok, msg = check_close(o4, o1, FWD_TOL[jnp.dtype(jnp.bfloat16)], "o")
    for name, a, b in zip(("dq", "dk", "dv"), g4, g1):
        gok, gmsg = check_close(a, b, BWD_TOL[jnp.dtype(jnp.bfloat16)], name)
        ok, msg = ok and gok, msg + "; " + gmsg
    checks.expect(ok and len(where) == 4,
                  f"multichip ulysses (1,1,4) vs one card: {msg}; "
                  f"shards on {where}")


# ───────────────────────────────── main ─────────────────────────────────────


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-card sharded LM step and its "
                         "one-card comparison")
    ap.add_argument("--phases", default="kernels,lm,unet,tests",
                    help="comma list of phases to run (one-card mode)")
    ap.add_argument("--timing", action="store_true",
                    help="also time each kernel regime against plain XLA "
                         "and cuDNN")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        import flashattn_tpu  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: the package is not beside this script ({e})")
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX finds no GPU (backend "
                 f"{jax.default_backend()!r}); nothing was run")
    from flashattn_tpu.utils.platform import (
        device_record, enable_compilation_cache)

    enable_compilation_cache()
    dev = jax.devices()[0]
    need = 4 if args.multichip else 1
    if len(jax.devices()) < need:
        sys.exit(f"chip_smoke: needs {need} GPUs, found {len(jax.devices())}")
    rec = device_record()
    log(f"card: {rec['card']}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; devices {rec['count']} x {rec['kind']}")

    checks = Checks()
    t_start = time.perf_counter()
    if args.multichip:
        run_multichip(checks, args.seed)
        count = 4
    else:
        phases = args.phases.split(",")
        rows = []
        if "kernels" in phases:
            run_kernels(checks, args.seed, args.timing, rows)
        if "lm" in phases:
            run_lm(checks, args.seed)
        if "unet" in phases:
            run_unet(checks, args.seed)
        if "tests" in phases:
            import pytest

            rc = pytest.main([os.path.join(HERE, "tests"), "-q", "-m", "gpu",
                              "-p", "no:xdist", "-p", "no:cacheprovider",
                              "-p", "no:randomly"])
            checks.expect(rc == 0, f"gpu-marked tests (pytest rc {rc})")
        count = 1
    log(f"elapsed {time.perf_counter() - t_start:.1f} s; "
        f"{len(checks.failed)} failed check(s)")
    if checks.failed:
        sys.exit("chip_smoke FAILED:\n  " + "\n  ".join(checks.failed))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)


if __name__ == "__main__":
    main()
