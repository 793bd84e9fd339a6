"""Backward kernels (custom_vjp) vs autodiff through the exact oracle.

The reference checks dQ/dK/dV max-abs diffs vs SDPA autograd
(precision_test.py:66-98); here every gradient is asserted against
``jax.grad`` of the f32 oracle, including the bias gradient the reference
never implemented (its mask arg is dead, FlashAttn.py:49), and the quirks the
build must not replicate (SURVEY.md §6: dQ log2e asymmetry, dQ races).
"""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu import flash_attention
from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.utils.testing import BWD_TOL, assert_close, make_qkv


def _grads(fn, *args):
    return jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 2, 256, 64, 256),
        (2, 3, 150, 64, 170),
        (1, 2, 129, 72, 65),
    ],
)
def test_bwd_matches_oracle(shape, causal):
    B, H, Nq, D, Nk = shape
    q, k, v = make_qkv(jax.random.PRNGKey(0), B, H, Nq, D, Nk=Nk)
    got = _grads(lambda q, k, v: flash_attention(q, k, v, causal=causal), q, k, v)
    want = _grads(lambda q, k, v: attention_reference(q, k, v, causal=causal), q, k, v)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, BWD_TOL[jnp.float32.dtype], name)


@pytest.mark.slow
def test_bwd_bias_grad():
    q, k, v = make_qkv(jax.random.PRNGKey(1), 2, 2, 100, 32, Nk=90)
    for bshape in [(2, 2, 100, 90), (1, 2, 100, 90), (1, 1, 100, 90)]:
        bias = jax.random.normal(jax.random.PRNGKey(2), bshape) * 0.5
        got = _grads(
            lambda q, k, v, b: flash_attention(q, k, v, bias=b, causal=True),
            q, k, v, bias,
        )
        want = _grads(
            lambda q, k, v, b: attention_reference(q, k, v, bias=b, causal=True),
            q, k, v, bias,
        )
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            assert_close(a, b, BWD_TOL[jnp.float32.dtype], f"{name}{bshape}")


def test_bwd_gqa():
    q, k, v = make_qkv(jax.random.PRNGKey(3), 1, 8, 128, 64, Hkv=2)
    got = _grads(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v)
    want = _grads(
        lambda q, k, v: attention_reference(q, k, v, causal=True), q, k, v
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, BWD_TOL[jnp.float32.dtype], name)


def test_bwd_bf16():
    q, k, v = make_qkv(jax.random.PRNGKey(4), 1, 2, 192, 64, dtype=jnp.bfloat16)
    got = _grads(lambda q, k, v: flash_attention(q, k, v), q, k, v)
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    want = _grads(lambda q, k, v: attention_reference(q, k, v), qf, kf, vf)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == jnp.bfloat16
        assert_close(a.astype(jnp.float32), b, BWD_TOL[jnp.bfloat16.dtype], name)


@pytest.mark.slow
def test_bwd_adversarial_reference_shape():
    """Backward through B3 H7 N1537 D111 Nkv1234 (precision_test.py:34-38),
    f32 for a tight bound; exercises all bwd padding/masking paths."""
    q, k, v = make_qkv(jax.random.PRNGKey(5), 3, 7, 1537, 111, Nk=1234)
    got = _grads(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v)
    want = _grads(
        lambda q, k, v: attention_reference(q, k, v, causal=True), q, k, v
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, BWD_TOL[jnp.float32.dtype], name)
