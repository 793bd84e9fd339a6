"""flax.linen integration: flash_attention_fn as a drop-in attention_fn.

Parity role: the reference is consumed by patching SDPA call sites in
existing models (reference README.md:6-15, 31-37); the flax equivalent is
nn.MultiHeadDotProductAttention's attention_fn hook. Every test pins the
fused path against flax's own nn.dot_product_attention on identical inputs.
"""

import jax
import jax.numpy as jnp
import pytest

nn = pytest.importorskip("flax.linen")  # optional dependency

from flashattn_tpu.integrations import (  # noqa: E402
    FlashMultiHeadDotProductAttention,
    flash_attention_fn,
    make_flash_attention_fn,
)


def _qkv(key, shape):
    kq, kk, kv = jax.random.split(key, 3)
    return (jax.random.normal(kq, shape, jnp.float32),
            jax.random.normal(kk, shape, jnp.float32),
            jax.random.normal(kv, shape, jnp.float32))


def test_matches_flax_dot_product_attention():
    q, k, v = _qkv(jax.random.PRNGKey(0), (2, 192, 4, 32))
    ours = flash_attention_fn(q, k, v, impl="fused")
    want = nn.dot_product_attention(q, k, v)
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5


@pytest.mark.slow
def test_bool_mask_and_bias():
    q, k, v = _qkv(jax.random.PRNGKey(1), (1, 128, 2, 32))
    mask = jax.random.bernoulli(
        jax.random.PRNGKey(2), 0.9, (1, 1, 128, 128))
    # keep at least the diagonal so no row is fully masked
    mask = jnp.logical_or(mask, jnp.eye(128, dtype=bool)[None, None])
    bias = 0.3 * jax.random.normal(jax.random.PRNGKey(3), (1, 2, 128, 128))
    ours = flash_attention_fn(q, k, v, bias=bias, mask=mask, impl="fused")
    want = nn.dot_product_attention(q, k, v, bias=bias, mask=mask)
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5


def test_causal_binding_matches_materialized_mask():
    q, k, v = _qkv(jax.random.PRNGKey(4), (2, 160, 4, 32))
    fn = make_flash_attention_fn(causal=True, impl="fused")
    ours = fn(q, k, v)
    want = nn.dot_product_attention(
        q, k, v, mask=nn.make_causal_mask(jnp.ones((2, 160))))
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5


def test_extra_batch_dims():
    q, k, v = _qkv(jax.random.PRNGKey(5), (2, 3, 96, 2, 32))
    ours = flash_attention_fn(q, k, v, impl="fused")
    want = nn.dot_product_attention(q, k, v)
    assert ours.shape == want.shape
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5


def test_dropout_rejected():
    q, k, v = _qkv(jax.random.PRNGKey(6), (1, 64, 2, 32))
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention_fn(q, k, v, dropout_rate=0.1, deterministic=False)
    # deterministic=True ignores the rate (flax eval-mode convention)
    out = flash_attention_fn(q, k, v, dropout_rate=0.1, deterministic=True)
    assert out.shape == q.shape


@pytest.mark.slow
def test_mhdpa_module_hook():
    """Full module: swapping attention_fn changes nothing numerically."""
    q = jax.random.normal(jax.random.PRNGKey(7), (2, 128, 64))
    ref_mod = nn.MultiHeadDotProductAttention(num_heads=4)
    our_mod = nn.MultiHeadDotProductAttention(
        num_heads=4, attention_fn=make_flash_attention_fn(impl="fused"))
    params = ref_mod.init(jax.random.PRNGKey(8), q)
    want = ref_mod.apply(params, q)
    ours = our_mod.apply(params, q)  # identical params, swapped core
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5


@pytest.mark.slow
def test_mhdpa_module_grads():
    q = jax.random.normal(jax.random.PRNGKey(9), (1, 96, 32))
    mod = nn.MultiHeadDotProductAttention(
        num_heads=2, attention_fn=make_flash_attention_fn(
            causal=True, impl="fused"))
    ref = nn.MultiHeadDotProductAttention(num_heads=2)
    params = mod.init(jax.random.PRNGKey(10), q)
    g_ours = jax.grad(lambda p: (mod.apply(p, q) ** 2).sum())(params)
    causal_mask = nn.make_causal_mask(jnp.ones((1, 96)))
    g_want = jax.grad(
        lambda p: (ref.apply(p, q, mask=causal_mask) ** 2).sum())(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_ours),
                    jax.tree_util.tree_leaves(g_want)):
        assert float(jnp.max(jnp.abs(a - b))) < 5e-4


def test_flash_mhdpa_subclass():
    q = jax.random.normal(jax.random.PRNGKey(11), (1, 128, 64))
    mod = FlashMultiHeadDotProductAttention(num_heads=4, causal=True)
    ref = nn.MultiHeadDotProductAttention(num_heads=4)
    params = mod.init(jax.random.PRNGKey(12), q)
    ours = mod.apply(params, q)
    want = ref.apply(params, q, mask=nn.make_causal_mask(jnp.ones((1, 128))))
    assert float(jnp.max(jnp.abs(ours - want))) < 2e-5
