"""Sliding-window (local) attention: fwd + grads vs the exact oracle,
composition with causal, tile-skipping correctness across tile boundaries."""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu import flash_attention
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.utils.testing import (BWD_TOL, FWD_TOL, assert_close,
                                          make_qkv)

CASES = [
    # (N, window, causal) — windows chosen to land inside/astride tiles
    (512, (127, 0), False),
    (512, (64, 64), False),
    (777, (200, -1), True),     # causal + left window (Mistral-style SWA)
    (300, (-1, 50), False),     # right-only window
    (1024, (33, 12), False),
]


@pytest.mark.parametrize("n,window,causal", CASES)
def test_window_fwd_matches_oracle(n, window, causal):
    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 2, n, 64)
    got = flash_attention(q, k, v, window=window, causal=causal)
    want = attention_reference(q, k, v, window=window, causal=causal)
    assert float(jnp.max(jnp.abs(got - want))) < 2e-5


def test_window_grads_match_oracle():
    n, window = 512, (100, 30)
    q, k, v = make_qkv(jax.random.PRNGKey(1), 1, 2, n, 64)

    def loss_fused(q, k, v):
        return (flash_attention(q, k, v, window=window) ** 2).sum()

    def loss_oracle(q, k, v):
        return (attention_reference(q, k, v, window=window)
                .astype(jnp.float32) ** 2).sum()

    g = jax.grad(loss_fused, (0, 1, 2))(q, k, v)
    gw = jax.grad(loss_oracle, (0, 1, 2))(q, k, v)
    for a, b in zip(g, gw):
        assert float(jnp.max(jnp.abs(a - b))) < 5e-4


def test_window_equals_causal_when_right_zero():
    """window=(-1, 0) must equal causal=True exactly (same tiles, same mask)."""
    q, k, v = make_qkv(jax.random.PRNGKey(2), 1, 2, 384, 64)
    a = flash_attention(q, k, v, window=(-1, 0))
    b = flash_attention(q, k, v, causal=True)
    assert float(jnp.max(jnp.abs(a - b))) == 0.0


def test_window_with_offsets():
    """Sequence-parallel caller: window masks use absolute positions."""
    q, k, v = make_qkv(jax.random.PRNGKey(3), 1, 2, 256, 64)
    got = flash_attention(q, k, v, window=(80, 0), q_offset=256,
                          kv_offset=128)
    want = attention_reference(q, k, v, window=(80, 0), q_offset=256,
                               kv_offset=128)
    assert float(jnp.max(jnp.abs(got - want))) < 2e-5


def test_window_bounded_grid_path():
    """Small blocks force the bounded-KV grid (kv_w < tk): numerics must
    match the oracle exactly across edge tiles."""
    from flashattn_tpu import BlockSizes

    bs = BlockSizes(block_q=128, block_k=128, block_q_dkv=128,
                    block_k_dkv=128, block_q_dq=128, block_k_dq=128)
    q, k, v = make_qkv(jax.random.PRNGKey(4), 1, 2, 1024, 64)
    for window, causal in (((100, 0), False), ((250, -1), True),
                           ((64, 32), False)):
        got = flash_attention(q, k, v, window=window, causal=causal,
                              block_sizes=bs)
        want = attention_reference(q, k, v, window=window, causal=causal)
        assert float(jnp.max(jnp.abs(got - want))) < 2e-5, (window, causal)


@pytest.mark.slow
def test_window_bounded_grid_grads():
    """Bounded bwd grids (small blocks, kv_w < tk): grads must match the
    oracle, including tiles clamped at the sequence edges."""
    from flashattn_tpu import BlockSizes

    bs = BlockSizes(block_q=128, block_k=128, block_q_dkv=128,
                    block_k_dkv=128, block_q_dq=128, block_k_dq=128)
    q, k, v = make_qkv(jax.random.PRNGKey(5), 1, 2, 1024, 64)
    for window, causal in (((100, 0), False), ((250, -1), True)):
        g = jax.grad(lambda q, k, v: (flash_attention(
            q, k, v, window=window, causal=causal, block_sizes=bs) ** 2).sum(),
            (0, 1, 2))(q, k, v)
        gw = jax.grad(lambda q, k, v: (attention_reference(
            q, k, v, window=window, causal=causal)
            .astype(jnp.float32) ** 2).sum(), (0, 1, 2))(q, k, v)
        for a, b in zip(g, gw):
            assert float(jnp.max(jnp.abs(a - b))) < 5e-4, (window, causal)


@pytest.mark.slow
def test_transformer_sliding_window():
    """LM with sliding_window: teacher-forced logits must equal a model with
    an equivalent additive band mask; decode must match teacher forcing."""
    import dataclasses

    from flashattn_tpu.models.transformer import (
        TransformerConfig, decode_step, init_kv_cache, init_transformer,
        transformer_forward,
    )

    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
        d_head=16, d_ff=64, dtype=jnp.float32, sliding_window=8,
    )
    params = init_transformer(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 24), 0, 64)
    logits = transformer_forward(params, toks, cfg)

    # decode with the windowed cache mask must reproduce the same logits
    cache = init_kv_cache(cfg, 1, 24)
    step = jax.jit(lambda c, t: decode_step(params, c, t, cfg))
    errs = []
    for t in range(12):
        lg, cache = step(cache, toks[:, t])
        errs.append(float(jnp.max(jnp.abs(lg - logits[:, t]))))
    tol = 1e-4
    assert max(errs) < tol, errs

    # and it must differ from the full-causal model (window actually binds)
    cfg_full = dataclasses.replace(cfg, sliding_window=None)
    logits_full = transformer_forward(params, toks, cfg_full)
    assert float(jnp.max(jnp.abs(logits - logits_full))) > 1e-3


@pytest.mark.slow
def test_ring_attention_window():
    """Sequence-parallel SWA: ring attention with a window must match the
    single-device oracle (global absolute-position masking across chunks)."""
    import pytest

    from flashattn_tpu.parallel import make_mesh
    from flashattn_tpu.parallel.ring import ring_attention_sharded

    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    mesh = make_mesh(data=1, model=1, seq=4)
    B, H, N, D = 1, 2, 512, 64
    q, k, v = make_qkv(jax.random.PRNGKey(6), B, H, N, D)
    for window, causal in (((200, 0), False), ((100, -1), True)):
        fn = ring_attention_sharded(mesh, causal=causal, window=window)
        got = fn(q, k, v)
        want = attention_reference(q, k, v, causal=causal, window=window)
        assert float(jnp.max(jnp.abs(got - want))) < 2e-5, (window, causal)


@pytest.mark.slow
def test_window_with_gqa_and_bias():
    """Window composes with GQA and a differentiable bias."""
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    q = jax.random.normal(ks[0], (1, 4, 320, 64), jnp.float32)
    k = jax.random.normal(ks[1], (1, 2, 320, 64), jnp.float32)
    v = jax.random.normal(ks[2], (1, 2, 320, 64), jnp.float32)
    bias = 0.3 * jax.random.normal(ks[3], (1, 1, 320, 320), jnp.float32)
    window = (96, 0)
    got = flash_attention(q, k, v, bias=bias, window=window)
    want = attention_reference(q, k, v, bias=bias, window=window)
    assert float(jnp.max(jnp.abs(got - want))) < 2e-5
    db = jax.grad(lambda b: (flash_attention(q, k, v, bias=b,
                                             window=window) ** 2).sum())(bias)
    dbw = jax.grad(lambda b: (attention_reference(
        q, k, v, bias=b, window=window) ** 2).sum())(bias)
    assert float(jnp.max(jnp.abs(db - dbw))) < 2e-3


@pytest.mark.slow
def test_window_gqa_unaligned_bf16_composition():
    """Composition stress over the resident band paths: GQA heads,
    causal+window band, non-tile-aligned N, bf16 storage — fwd and grads
    vs the f32 oracle."""
    q, k, v = make_qkv(jax.random.PRNGKey(70), 1, 4, 700, 64, Hkv=2,
                       dtype=jnp.bfloat16)
    kw = dict(causal=True, window=(96, 0))
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    got = flash_attention(q, k, v, **kw)
    want = attention_reference(qf, kf, vf, **kw)
    assert_close(got.astype(jnp.float32), want,
                 FWD_TOL[jnp.bfloat16.dtype])
    g = jax.grad(lambda q, k, v: (
        flash_attention(q, k, v, **kw).astype(jnp.float32) ** 2).sum(),
        (0, 1, 2))(q, k, v)
    gw = jax.grad(lambda q, k, v: (
        attention_reference(q, k, v, **kw) ** 2).sum(), (0, 1, 2))(
        qf, kf, vf)
    for name, a, b in zip(("dq", "dk", "dv"), g, gw):
        assert_close(a.astype(jnp.float32), b,
                     BWD_TOL[jnp.bfloat16.dtype], name)
