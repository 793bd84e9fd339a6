"""Forward and backward kernels against the f32 oracle across the feature
matrix — causal × window × GQA × segments × soft-cap × bias/dbias ×
unaligned N × traced offsets — in Pallas interpret mode here, and compiled
on the card (``gpu``-marked, run by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import flash_attention
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.utils.testing import (
    BWD_TOL,
    FWD_TOL,
    assert_close,
    make_qkv,
)

# name: (B, Hq, Hkv, Nq, Nk, D, options)
MATRIX = {
    "plain_aligned": (1, 2, 2, 128, 128, 64, {}),
    "unaligned_cross": (2, 3, 3, 150, 77, 40, {}),
    "causal_gqa_unaligned": (1, 4, 2, 200, 200, 72, {"causal": True}),
    "causal_traced_offsets": (1, 2, 1, 96, 160, 32,
                              {"causal": True, "offsets": (64, 0)}),
    "window_both_sides": (1, 2, 2, 190, 190, 32, {"window": (40, 24)}),
    "causal_window_gqa": (1, 4, 2, 180, 180, 32,
                          {"causal": True, "window": (50, 0)}),
    "segments_causal_gqa": (2, 4, 2, 160, 160, 32,
                            {"causal": True, "segments": 3}),
    "softcap_causal": (1, 2, 2, 144, 144, 64,
                       {"causal": True, "logit_softcap": 5.0}),
    "bias_full_dbias": (2, 2, 2, 100, 90, 32, {"bias": (2, 2, 100, 90)}),
    "bias_rows1_dbias": (1, 4, 2, 120, 120, 32,
                         {"bias": (1, 1, 1, 120), "causal": True}),
    "everything": (1, 4, 2, 170, 170, 48,
                   {"causal": True, "window": (60, -1), "segments": 2,
                    "logit_softcap": 8.0, "bias": (1, 4, 170, 170)}),
    # A short side shrinks the tiles to the sequence (fit_block), so the
    # kernels launch at tiles the launch table never names.
    "short_q_d64": (1, 4, 2, 20, 300, 64, {}),
    "short_q_d128": (1, 4, 2, 20, 300, 128, {}),
    "short_kv_d128": (1, 4, 2, 300, 20, 128, {}),
    "single_q_d256": (1, 4, 2, 1, 300, 256, {}),
    "short_q_d256": (1, 2, 2, 40, 300, 256, {}),
    "short_kv_d256": (2, 2, 2, 300, 20, 256, {}),
}


def _inputs(name, dtype):
    B, Hq, Hkv, Nq, Nk, D, opts = MATRIX[name]
    key = jax.random.PRNGKey(sorted(MATRIX).index(name))
    q, k, v = make_qkv(key, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv, dtype=dtype)
    kw = {x: opts[x] for x in ("causal", "window", "logit_softcap")
          if x in opts}
    if "offsets" in opts:
        kw["q_offset"], kw["kv_offset"] = opts["offsets"]
    if "segments" in opts:
        rng = np.random.default_rng(0)
        cuts = np.sort(rng.choice(np.arange(1, Nq), opts["segments"] - 1,
                                  replace=False))
        seg = np.searchsorted(cuts, np.arange(Nq), side="right")
        kw["segment_ids"] = jnp.asarray(np.tile(seg, (B, 1)), jnp.int32)
    bias = None
    if "bias" in opts:
        bias = 0.5 * jax.random.normal(jax.random.PRNGKey(7), opts["bias"])
    return q, k, v, bias, kw


def _ref_kw(kw):
    r = dict(kw)
    if "segment_ids" in r:
        r["segment_ids"] = (r["segment_ids"], r["segment_ids"])
    return r


def _check(name, dtype, interpret):
    q, k, v, bias, kw = _inputs(name, dtype)
    ct = jax.random.normal(jax.random.PRNGKey(3), q.shape, jnp.float32)
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)

    def loss(attn, cast, extra):
        def f(q, k, v, b):
            o = attn(cast(q), cast(k), cast(v), bias=b, **extra)
            return jnp.sum(o.astype(jnp.float32) * ct)
        return f

    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    got = flash_attention(q, k, v, bias=bias, interpret=interpret, **kw)
    want = attention_reference(f32(q), f32(k), f32(v), bias=bias,
                               **_ref_kw(kw))
    assert got.dtype == q.dtype
    assert_close(got.astype(jnp.float32), want, FWD_TOL[jnp.dtype(dtype)])
    grads = jax.grad(loss(flash_attention, lambda x: x,
                          dict(kw, interpret=interpret)), argnums)(
        q, k, v, bias)
    grads_want = jax.grad(loss(attention_reference, f32, _ref_kw(kw)),
                          argnums)(q, k, v, bias)
    for gname, g, gw in zip(("dq", "dk", "dv", "dbias"), grads, grads_want):
        assert_close(g.astype(jnp.float32), gw, BWD_TOL[jnp.dtype(dtype)],
                     gname)


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_f32(name):
    _check(name, jnp.float32, interpret=None)


@pytest.mark.parametrize("name", ["causal_gqa_unaligned", "everything"])
def test_matrix_fp16_native(name):
    """fp16 runs natively (no cast to bf16): results stay fp16-accurate."""
    _check(name, jnp.float16, interpret=None)
    q, k, v, bias, kw = _inputs(name, jnp.float16)
    jaxpr = str(jax.make_jaxpr(lambda q, k, v: flash_attention(
        q, k, v, bias=bias, **kw))(q, k, v))
    assert "bf16" not in jaxpr


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_compiled_on_gpu(gpu, name):
    _check(name, jnp.bfloat16, interpret=False)
