"""Measure the Hopper launch table (``ops/flash_fwd._FWD_TABLE`` and the
backward tables): time candidate (block_q, block_k, num_warps, num_stages)
configs of each kernel per head-dim class and print one JSON line each.

    python benchmarks/tune_blocks.py                    # on one GPU
    python benchmarks/tune_blocks.py --dims 128 --kernels bwd

Shape per class: B=1, H=16, N=4096, bf16, noncausal (the D.2 regimes of
chip_smoke.py). The forward is timed alone; each (dK/dV, dQ) candidate pair
is timed as forward (at the table config) + backward.

Each candidate is first checked against the f32 oracle (forward output, or
dQ/dK/dV of ``sum(O * ct)``): it must meet the repo's bf16 tolerances and
stay within 4x the max-abs error of the table's own config (sound tiles
agree to the bit here; wrong dK at 0.05 passed the tolerance alone). One
that computes wrong values prints ``"wrong"`` with its max-abs errors and is
not timed. Configs that the GPU compiler refuses (shared memory,
registers) print their error. A winner goes into the tables by hand, and
only after ``chip_smoke.py`` passes with it (one fast forward overflowed
shared memory once a bias was added).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from flashattn_tpu.ops import flash_bwd, flash_fwd
from flashattn_tpu.ops.flash_fwd import KernelConfig as K
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.utils.platform import device_record, enable_compilation_cache
from flashattn_tpu.utils.testing import BWD_TOL, FWD_TOL, check_close, make_qkv
from flashattn_tpu.utils.timing import time_chained

FWD = {
    64: [K(128, 64, 4, 3), K(128, 128, 4, 3), K(64, 64, 4, 3)],
    128: [K(128, 64, 8, 3), K(128, 64, 4, 3), K(128, 128, 8, 2)],
    256: [K(64, 32, 8, 2), K(128, 32, 8, 2), K(64, 64, 8, 2)],
}
# (dkv, dq) pairs: dkv tiles KV by block_k and steps Q by block_q; dq the
# transpose.
BWD = {
    64: [(K(64, 64, 4, 2), K(64, 64, 4, 2)), (K(32, 128, 4, 3), K(128, 32, 4, 3)),
         (K(64, 128, 8, 2), K(128, 64, 8, 2))],
    # no 32-row dK/dV Q step at D=128: refused (flash_fwd.DKV_REFUSED_BLOCK_Q)
    128: [(K(64, 64, 8, 2), K(64, 64, 8, 2)), (K(64, 64, 8, 2), K(128, 32, 8, 3)),
          (K(64, 128, 8, 3), K(128, 32, 8, 3)), (K(16, 64, 8, 2), K(128, 32, 8, 3))],
    256: [(K(32, 32, 8, 2), K(32, 32, 8, 2)), (K(16, 64, 8, 2), K(64, 16, 8, 2)),
          (K(32, 64, 8, 1), K(64, 32, 8, 1))],
}


def _gate(got, want, tol, names, base=None):
    """(ok, {name: max-abs error}) of each output against the oracle: within
    ``tol`` and, given the table config's errors ``base``, within 4x them."""
    ok, err = True, {}
    for name, g, w in zip(names, got, want):
        good, _ = check_close(g, w, tol, name)
        err[name] = float(jnp.max(jnp.abs(g.astype(jnp.float32) - w)))
        if base is not None:
            good = good and err[name] <= 4 * base[name]
        ok = ok and good
    return ok, err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", default="64,128,256",
                    help="head-dim classes to tune")
    ap.add_argument("--kernels", default="fwd,bwd",
                    help="fwd, bwd or both")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        sys.exit("tune_blocks.py: needs a GPU")
    enable_compilation_cache()
    print(json.dumps({"device": device_record()}), flush=True)
    kernels = args.kernels.split(",")
    for d in map(int, args.dims.split(",")):
        q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 16, 4096, d,
                           dtype=jnp.bfloat16)
        ct = jax.random.normal(jax.random.PRNGKey(1), q.shape, jnp.float32)
        offs = jnp.zeros((2,), jnp.int32)
        scale = d ** -0.5
        f32 = [x.astype(jnp.float32) for x in (q, k, v)]
        o_want, vjp = jax.vjp(attention_reference, *f32)
        g_want = vjp(ct)

        def fwd(q, k, v, cfg):
            return flash_fwd.fwd(q, k, v, offsets=offs, scale=scale,
                                 causal=False, return_lse=True, config=cfg)

        def grads(q, k, v, dkv, dq):
            o, lse = fwd(q, k, v, None)
            return flash_bwd.bwd(q, k, v, o, lse, ct.astype(q.dtype),
                                 offsets=offs, scale=scale, causal=False,
                                 dkv_config=dkv, dq_config=dq)[:3]

        fwd_base = _gate([jax.jit(fwd, static_argnums=3)(q, k, v, None)[0]],
                         [o_want], FWD_TOL[q.dtype], ["o"])[1]
        bwd_base = _gate(jax.jit(grads, static_argnums=(3, 4))(
            q, k, v, None, None), g_want, BWD_TOL[q.dtype],
            ["dq", "dk", "dv"])[1]
        print(json.dumps({"D": d, "table_maxabs": {**fwd_base, **bwd_base}}),
              flush=True)
        for cfg in FWD[d] if "fwd" in kernels else ():
            rec = {"kernel": "fwd", "D": d, "config": list(cfg.__dict__.values())}
            try:
                ok, rec["maxabs"] = _gate(
                    [jax.jit(fwd, static_argnums=3)(q, k, v, cfg)[0]],
                    [o_want], FWD_TOL[q.dtype], ["o"], fwd_base)
                if not ok:
                    rec["wrong"] = True
                else:
                    rec["ms"] = 1e3 * time_chained(
                        lambda qq, k, v: fwd(qq, k, v, cfg)[0], q,
                        consts=(k, v), iters=20, warmup_iters=2, repeats=3)
            except Exception as e:  # noqa: BLE001 — the compiler refused it
                rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            print(json.dumps(rec), flush=True)
        for dkv, dq in BWD[d] if "bwd" in kernels else ():
            def step(qq, k, v):
                g = grads(qq, k, v, dkv, dq)
                return qq + (1e-30 * (g[0].astype(jnp.float32)
                                      + g[1].astype(jnp.float32).sum()
                                      + g[2].astype(jnp.float32).sum())
                             ).astype(qq.dtype)

            rec = {"kernel": "fwd+bwd", "D": d,
                   "dkv": list(dkv.__dict__.values()),
                   "dq": list(dq.__dict__.values())}
            try:
                ok, rec["maxabs"] = _gate(
                    jax.jit(grads, static_argnums=(3, 4))(q, k, v, dkv, dq),
                    g_want, BWD_TOL[q.dtype], ["dq", "dk", "dv"], bwd_base)
                if not ok:
                    rec["wrong"] = True
                else:
                    rec["ms"] = 1e3 * time_chained(
                        step, q, consts=(k, v), iters=10, warmup_iters=2,
                        repeats=3)
            except Exception as e:  # noqa: BLE001
                rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
