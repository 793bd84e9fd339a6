"""Layout handling ([B,N,H,D] a.k.a. BNHD_fmt) and the SDPA adapter.

Parity with the reference's permute_NH path (kernel_fp16.cu:327-335,
test_arrange.py:23-30) and its SDPA drop-in role (README.md:31-37).
"""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu import flash_attention, scaled_dot_product_attention
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv


def test_bnhd_matches_bhnd():
    q, k, v = make_qkv(jax.random.PRNGKey(0), 2, 3, 150, 64, Nk=170)
    want = flash_attention(q, k, v, causal=True)
    got = flash_attention(
        q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
        causal=True, layout="BNHD",
    )
    assert got.shape == (2, 150, 3, 64)
    assert_close(got.swapaxes(1, 2), want, FWD_TOL[jnp.float32.dtype])


def test_bnhd_grads():
    q, k, v = make_qkv(jax.random.PRNGKey(1), 1, 2, 96, 32)
    qn, kn, vn = (x.swapaxes(1, 2) for x in (q, k, v))

    g_bhnd = jax.grad(lambda *a: (flash_attention(*a) ** 2).sum(), (0, 1, 2))(q, k, v)
    g_bnhd = jax.grad(
        lambda *a: (flash_attention(*a, layout="BNHD") ** 2).sum(), (0, 1, 2)
    )(qn, kn, vn)
    for name, a, b in zip(("dq", "dk", "dv"), g_bnhd, g_bhnd):
        assert_close(a.swapaxes(1, 2), b, BWD_TOL[jnp.float32.dtype], name)


def test_sdpa_causal():
    q, k, v = make_qkv(jax.random.PRNGKey(2), 1, 4, 128, 64)
    want = attention_reference(q, k, v, causal=True)
    got = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_sdpa_bool_mask():
    q, k, v = make_qkv(jax.random.PRNGKey(3), 1, 2, 100, 32, Nk=80)
    mask = jax.random.bernoulli(jax.random.PRNGKey(4), 0.8, (100, 80))
    # guarantee at least one visible kv per row to keep softmax well-defined
    mask = mask.at[:, 0].set(True)
    bias = jnp.where(mask, 0.0, -1e9)
    want = attention_reference(q, k, v, bias=bias[None, None])
    got = scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_sdpa_additive_mask():
    q, k, v = make_qkv(jax.random.PRNGKey(5), 2, 2, 64, 32)
    am = jax.random.normal(jax.random.PRNGKey(6), (2, 2, 64, 64)) * 0.3
    want = attention_reference(q, k, v, bias=am)
    got = scaled_dot_product_attention(q, k, v, attn_mask=am)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_sdpa_custom_scale():
    q, k, v = make_qkv(jax.random.PRNGKey(7), 1, 2, 64, 32)
    want = attention_reference(q, k, v, scale=0.25)
    got = scaled_dot_product_attention(q, k, v, scale=0.25)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_sdpa_impl_dispatch_agreement():
    """auto/fused/exact must agree; auto takes the fused kernel for every
    shape, including SD's 77-token cross-attention."""
    import jax
    import jax.numpy as jnp

    import pytest

    from flashattn_tpu.ops.sdpa import scaled_dot_product_attention as sdpa

    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (1, 2, 256, 64), jnp.float32)
    for nk, causal in ((320, True), (77, False)):   # 77: SD cross-attention
        k = jax.random.normal(ks[1], (1, 2, nk, 64), jnp.float32)
        v = jax.random.normal(ks[2], (1, 2, nk, 64), jnp.float32)
        outs = {impl: sdpa(q, k, v, is_causal=causal, impl=impl)
                for impl in ("auto", "fused", "exact")}
        assert float(jnp.max(jnp.abs(outs["auto"] - outs["fused"]))) == 0.0
        assert float(jnp.max(jnp.abs(outs["fused"] - outs["exact"]))) < 2e-5
    with pytest.raises(ValueError, match="unknown impl"):
        sdpa(q, k, v, impl="cudnn")
