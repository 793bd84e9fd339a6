"""Quantized-KV attention and timing utils."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.oracle import attention_reference
from flashattn_tpu.ops.quant import (
    QuantizedKV,
    dequantize_kv,
    flash_attention_quantized,
    quantize_kv,
)
from flashattn_tpu.utils.testing import FWD_TOL, assert_close, make_qkv
from flashattn_tpu.utils.timing import attention_flops, summarize


@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
@pytest.mark.parametrize("causal", [False, True])
def test_quantized_matches_dequant_oracle(qdtype, causal):
    """In-kernel dequant must equal attention over the dequantized cache —
    isolates kernel plumbing from quantization error."""
    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 2, 200, 64, Nk=150,
                       dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=qdtype)
    got = flash_attention_quantized(q, qkv, causal=causal)
    kd, vd = dequantize_kv(qkv, jnp.float32)
    want = attention_reference(q.astype(jnp.float32), kd, vd, causal=causal)
    assert_close(got.astype(jnp.float32), want, FWD_TOL[jnp.bfloat16.dtype])


def test_quantized_close_to_full_precision():
    """int8 per-token quantization error stays small on unit-scale inputs."""
    q, k, v = make_qkv(jax.random.PRNGKey(1), 1, 4, 256, 64, dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=jnp.int8)
    got = flash_attention_quantized(q, qkv)
    want = attention_reference(
        *(x.astype(jnp.float32) for x in (q, k, v))
    )
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
    assert err < 0.05, err


def test_quantized_bnhd_layout():
    q, k, v = make_qkv(jax.random.PRNGKey(2), 1, 2, 128, 64, dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v)
    want = flash_attention_quantized(q, qkv)
    qkv_n = QuantizedKV(
        jnp.swapaxes(qkv.k_q, 1, 2), jnp.swapaxes(qkv.k_scale, 1, 2),
        jnp.swapaxes(qkv.v_q, 1, 2), jnp.swapaxes(qkv.v_scale, 1, 2),
    )
    got = flash_attention_quantized(q.swapaxes(1, 2), qkv_n, layout="BNHD")
    assert_close(got.swapaxes(1, 2).astype(jnp.float32),
                 want.astype(jnp.float32), FWD_TOL[jnp.bfloat16.dtype])


def test_attention_flops_model():
    # the reference accounting: fpm = 2BHN²D; fwd 2x, bwd 5x, causal halves
    assert attention_flops(1, 1, 128, 128, 64, causal=False, mode="fwd") == (
        2 * 2 * 128 * 128 * 64
    )
    assert attention_flops(2, 3, 64, 32, 16, causal=True, mode="bwd") == (
        5 * 2 * 2 * 3 * 64 * 32 * 16 * 0.5
    )


def test_summarize_stats():
    s = summarize([1.0, 2.0, 3.0])
    assert abs(s["mean"] - 2.0) < 1e-9
    assert s["min"] == 1.0
    assert abs(s["std"] - np.std([1.0, 2.0, 3.0])) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantized_attention_compiles_on_gpu(gpu, qdtype):
    """The compiled quantized path: the 1-byte payload converts to the
    query dtype in registers and the scales load per KV tile — lowering
    details the interpreter does not see."""
    q, k, v = make_qkv(jax.random.PRNGKey(0), 2, 8, 1, 128, Nk=4096, Hkv=2,
                       dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, qdtype)
    o = flash_attention_quantized(q, qkv, interpret=False)
    kd, vd = dequantize_kv(qkv, jnp.float32)
    want = attention_reference(q.astype(jnp.float32), kd, vd)
    assert_close(o.astype(jnp.float32), want, FWD_TOL[jnp.bfloat16.dtype])


def test_fp8_stays_fp8():
    """fp8 requests quantize as fp8 (no device-kind fallback)."""
    _, k, v = make_qkv(jax.random.PRNGKey(3), 1, 2, 64, 64,
                       dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, dtype=jnp.float8_e4m3fn)
    assert qkv.k_q.dtype == jnp.float8_e4m3fn
    assert qkv.v_q.dtype == jnp.float8_e4m3fn
