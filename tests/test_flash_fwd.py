"""Forward kernel vs exact-softmax oracle (Pallas interpret mode on CPU).

Covers the reference's precision-test matrix (SURVEY.md §4): adversarial
unaligned shapes (precision_test.py:34-38), Nkv ≠ N, D not a multiple of the
tile, causal, bias, GQA, dtype dispatch, and the LSE residual.
"""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu import flash_attention, flash_attention_with_lse
from flashattn_tpu.ops.flash import BlockSizes
from flashattn_tpu.ops.oracle import (
    attention_reference,
    attention_reference_with_lse,
)
from flashattn_tpu.utils.testing import FWD_TOL, assert_close, make_qkv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 2, 256, 64, 256),   # aligned
        (2, 3, 150, 64, 170),   # unaligned N, Nkv > Nq
        (1, 2, 257, 72, 129),   # everything unaligned
    ],
)
def test_fwd_matches_oracle_f32(shape, causal):
    B, H, Nq, D, Nk = shape
    q, k, v = make_qkv(jax.random.PRNGKey(0), B, H, Nq, D, Nk=Nk)
    want = attention_reference(q, k, v, causal=causal)
    got = flash_attention(q, k, v, causal=causal)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
def test_fwd_dtypes(dtype):
    q, k, v = make_qkv(jax.random.PRNGKey(1), 1, 3, 192, 64, dtype=dtype)
    want = attention_reference(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32)
    )
    got = flash_attention(q, k, v)
    assert got.dtype == dtype
    assert_close(got.astype(jnp.float32), want, FWD_TOL[jnp.dtype(dtype)])


@pytest.mark.slow
def test_fwd_adversarial_reference_shape():
    """The reference's nastiest shape: B3 H7 N1537 D111 Nkv1234 bf16
    (precision_test.py:34-38) — exercises all padding + tail-mask paths."""
    q, k, v = make_qkv(
        jax.random.PRNGKey(2), 3, 7, 1537, 111, Nk=1234, dtype=jnp.bfloat16
    )
    want = attention_reference(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32)
    )
    got = flash_attention(q, k, v)
    assert_close(got.astype(jnp.float32), want, FWD_TOL[jnp.bfloat16.dtype])


def test_fwd_bias_broadcast():
    q, k, v = make_qkv(jax.random.PRNGKey(3), 2, 4, 100, 32, Nk=90)
    for bshape in [(2, 4, 100, 90), (1, 4, 100, 90), (2, 1, 100, 90), (1, 1, 100, 90)]:
        bias = jax.random.normal(jax.random.PRNGKey(4), bshape) * 0.5
        want = attention_reference(q, k, v, bias=bias)
        got = flash_attention(q, k, v, bias=bias)
        assert_close(got, want, FWD_TOL[jnp.float32.dtype], f"bias{bshape}")


def test_fwd_gqa():
    q, k, v = make_qkv(jax.random.PRNGKey(5), 2, 8, 128, 64, Hkv=2)
    want = attention_reference(q, k, v, causal=True)
    got = flash_attention(q, k, v, causal=True)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_fwd_lse():
    q, k, v = make_qkv(jax.random.PRNGKey(6), 1, 2, 130, 64, Nk=200)
    _, lse_want = attention_reference_with_lse(q, k, v)
    o, lse = flash_attention_with_lse(q, k, v)
    assert lse.shape == (1, 2, 130)
    assert_close(lse, lse_want, FWD_TOL[jnp.float32.dtype], "lse")


def test_fwd_offsets_shift_causal_mask():
    """q_offset/kv_offset emulate a chunk of a longer sequence (the ring-
    attention contract): computing rows [64:128) against the full KV must
    match slicing the full causal result."""
    q, k, v = make_qkv(jax.random.PRNGKey(7), 1, 2, 128, 64)
    full = attention_reference(q, k, v, causal=True)
    got = flash_attention(q[:, :, 64:], k, v, causal=True, q_offset=64)
    assert_close(got, full[:, :, 64:], FWD_TOL[jnp.float32.dtype])


def test_fwd_custom_blocks_and_scale():
    q, k, v = make_qkv(jax.random.PRNGKey(8), 1, 2, 300, 64, Nk=300)
    want = attention_reference(q, k, v, scale=0.1)
    got = flash_attention(
        q, k, v, scale=0.1,
        block_sizes=BlockSizes(128, 128, 128, 128, 128, 128),
    )
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_fwd_nq1_decode_shape():
    """Single-query decode step (LLM inference path)."""
    q, k, v = make_qkv(jax.random.PRNGKey(9), 2, 4, 1, 64, Nk=333)
    want = attention_reference(q, k, v)
    got = flash_attention(q, k, v)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])


def test_validation_errors():
    q, k, v = make_qkv(jax.random.PRNGKey(10), 1, 2, 64, 32)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)  # rank 3
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :, :16], v[:, :, :, :16])  # D mismatch
    with pytest.raises(ValueError):
        flash_attention(q, k, v, layout="NHBD")
    with pytest.raises(ValueError):
        flash_attention(
            q, k, v, bias=jnp.zeros((1, 2, 64, 32))  # Nk mismatch
        )

def test_gqa_decode_fold_matches_oracle():
    """Tiny-Nq non-causal GQA routes through the head-fold (rep q-heads
    become Q-tile rows so the cache is read once); numerics must match the
    per-head oracle exactly, including the grad path (pure reshapes)."""
    q, k, v = make_qkv(jax.random.PRNGKey(30), 2, 8, 2, 64, Nk=384, Hkv=2)
    want = attention_reference(q, k, v)
    got = flash_attention(q, k, v)
    assert_close(got, want, FWD_TOL[jnp.float32.dtype])
    g = jax.grad(lambda k: (flash_attention(q, k, v) ** 2).sum())(k)
    gw = jax.grad(lambda k: (attention_reference(q, k, v) ** 2).sum())(k)
    assert_close(g, gw, FWD_TOL[jnp.float32.dtype], "dk")
    # causal / window / bias / big-Nq keep the unfolded route (soundness)
    got_c = flash_attention(q, k, v, causal=True, q_offset=382)
    want_c = attention_reference(q, k, v, causal=True, q_offset=382)
    assert_close(got_c, want_c, FWD_TOL[jnp.float32.dtype], "causal")
    # head-broadcast bias (decode's cache-slot mask) IS fold-safe —
    # row-dependent variant exercises the head-major row tiling
    for bshape in ((1, 1, 1, 384), (2, 1, 2, 384)):
        bias = jnp.where(
            jax.random.uniform(jax.random.PRNGKey(31), bshape) > 0.3,
            0.0, -1e9).astype(jnp.float32)
        got_b = flash_attention(q, k, v, bias=bias)
        want_b = attention_reference(q, k, v, bias=bias)
        assert_close(got_b, want_b, FWD_TOL[jnp.float32.dtype],
                     f"bias{bshape}")
