"""Kernel plumbing that the CPU can check exactly: tile-range bounds against
brute force, head-dim padding, the launch table, the backend rule, the
compile-cache rule, and the Triton lowering of every kernel variant (the
Pallas → Triton IR step runs here; only the GPU compiler needs the card)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import flash_attention
from flashattn_tpu.ops import flash_bwd, flash_fwd
from flashattn_tpu.ops.flash import BlockSizes, choose_block_sizes, explain_plan
from flashattn_tpu.ops.quant import flash_attention_quantized, quantize_kv
from flashattn_tpu.utils import platform
from flashattn_tpu.utils.testing import make_qkv


def _brute_mask(rows, cols, d, causal, window, kv_len, q_len=None):
    """numpy pair mask (True = attend) of absolute-offset geometry."""
    i = np.asarray(rows)[:, None]
    j = np.asarray(cols)[None, :]
    wl, wr = window if window is not None else (-1, -1)
    m = j < kv_len
    if q_len is not None:
        m = m & (i < q_len)
    rel = j - i - d
    if causal:
        m = m & (rel <= 0)
    elif wr >= 0:
        m = m & (rel <= wr)
    if wl >= 0:
        m = m & (rel >= -wl)
    return m


RANGE_CASES = [
    # causal, window, d (q_off - kv_off), kv_len
    (False, None, 0, 160),
    (False, None, 0, 150),
    (True, None, 0, 160),
    (True, None, 40, 150),
    (True, None, -37, 160),
    (True, (50, -1), 0, 160),
    (False, (30, 20), 5, 160),
    (False, (-1, 10), -20, 140),
]


@pytest.mark.parametrize("causal,window,d,kv_len", RANGE_CASES)
def test_kv_block_range_matches_brute_force(causal, window, d, kv_len):
    """Forward/dQ loop bounds: every KV tile holding an unmasked pair is
    visited, and every interior (unmasked) tile really has no masked pair."""
    bq, bk, nq = 32, 16, 160
    nkb = flash_fwd.round_up(kv_len, bk) // bk
    for r0 in range(0, nq, bq):
        lo, flo, fhi, hi = (int(x) for x in flash_fwd.kv_block_range(
            jnp.int32(r0), jnp.int32(d), block_q=bq, block_k=bk,
            causal=causal, window=window, kv_len=kv_len, mask_all=False))
        assert 0 <= lo <= flo <= fhi <= hi <= nkb
        rows = np.arange(r0, r0 + bq)
        for j in range(nkb):
            m = _brute_mask(rows, np.arange(j * bk, (j + 1) * bk), d,
                            causal, window, kv_len)
            if m.any():
                assert lo <= j < hi, (r0, j)
            if flo <= j < fhi:
                assert m.all(), (r0, j)


@pytest.mark.parametrize("causal,window,d,kv_len", RANGE_CASES)
def test_q_block_range_matches_brute_force(causal, window, d, kv_len):
    """dK/dV loop bounds: the transpose of the forward's."""
    bq, bk, q_len = 16, 32, 150
    nqb = flash_fwd.round_up(q_len, bq) // bq
    nkp = flash_fwd.round_up(kv_len, bk)
    for c0 in range(0, nkp, bk):
        lo, flo, fhi, hi = (int(x) for x in flash_bwd.q_block_range(
            jnp.int32(c0), jnp.int32(d), block_q=bq, block_k=bk,
            causal=causal, window=window, kv_len=kv_len, q_len=q_len,
            mask_all=False))
        assert 0 <= lo <= flo <= fhi <= hi <= nqb
        cols = np.arange(c0, c0 + bk)
        for t in range(nqb):
            m = _brute_mask(np.arange(t * bq, (t + 1) * bq), cols, d,
                            causal, window, kv_len, q_len)
            if m.any():
                assert lo <= t < hi, (c0, t)
            if flo <= t < fhi:
                assert m.all(), (c0, t)


def test_block_ranges_mask_all_has_no_interior():
    """Segment ids make every visited tile an edge tile."""
    r = flash_fwd.kv_block_range(jnp.int32(0), jnp.int32(0), block_q=32,
                                 block_k=16, causal=False, window=None,
                                 kv_len=160, mask_all=True)
    lo, flo, fhi, hi = (int(x) for x in r)
    assert (lo, hi) == (0, 10) and flo == fhi == hi


@pytest.mark.parametrize("d,want", [(16, 16), (32, 32), (40, 64), (64, 64),
                                    (72, 128), (80, 128), (111, 128),
                                    (128, 128), (160, 256), (256, 256)])
def test_pad_head_dim_powers_of_two(d, want):
    """Triton tiles are powers of two: SD1.5's D=40/80/160 pad to
    64/128/256."""
    assert flash_fwd.pad_head_dim(d) == want


@pytest.mark.parametrize("nq,nk,d", [(4096, 4096, 128), (1, 32768, 128),
                                     (77, 77, 40), (1537, 1234, 111),
                                     (8192, 8192, 256), (20, 4096, 64)])
def test_block_table_powers_of_two_and_fitted(nq, nk, d):
    bs = choose_block_sizes(nq, nk, d)
    for f in ("block_q", "block_k", "block_q_dkv", "block_k_dkv",
              "block_q_dq", "block_k_dq"):
        b = getattr(bs, f)
        assert b >= 16 and b & (b - 1) == 0, (f, b)
    # a short sequence takes the smallest tile that covers it
    assert bs.block_q <= max(16, 1 << (nq - 1).bit_length())
    assert bs.block_k <= max(16, 1 << (nk - 1).bit_length())


@pytest.mark.parametrize("bad", [8, 48, 100, 0])
def test_block_sizes_reject_non_powers_of_two(bad):
    with pytest.raises(ValueError):
        BlockSizes(block_q=bad)


@pytest.mark.parametrize("nq,d,want", [(20, 128, 64), (32, 111, 64),
                                       (16, 128, 16), (4096, 128, 64),
                                       (20, 64, 32), (20, 256, 32)])
def test_dkv_q_step_skips_refused_size(nq, d, want):
    """A 32-row dK/dV Q step computed wrong dK on the card at head-dim class
    128: short sequences step by 64 there; the other classes keep 32."""
    assert choose_block_sizes(nq, 4096, d).block_q_dkv == want


@pytest.mark.parametrize("d", [72, 128])
def test_refused_dkv_tiles_raise(d):
    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 2, 64, d, dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="wrong dK"):
        flash_attention(q, k, v, block_sizes=BlockSizes(block_q_dkv=32))
    o, lse = flash_fwd.fwd(q, k, v, offsets=(0, 0), scale=d ** -0.5,
                           causal=False, return_lse=True)
    with pytest.raises(ValueError, match="wrong dK"):
        flash_bwd.bwd(q, k, v, o, lse, o, offsets=(0, 0), scale=d ** -0.5,
                      causal=False,
                      dkv_config=flash_fwd.KernelConfig(32, 128, 8, 3))


def test_explain_plan_grids():
    info = explain_plan((2, 16, 1000, 80), (2, 8, 1000, 80), causal=True)
    assert info["d_padded"] == 128
    assert info["nq_padded"] % info["block_q"] == 0
    assert info["fwd_grid"] == (info["nq_padded"] // info["block_q"], 2, 16)
    assert info["dkv_grid"][1:] == (2, 8)


@pytest.mark.parametrize("backend,want", [("cpu", True), ("gpu", False),
                                          ("cuda", False), ("rocm", None)])
def test_interpret_only_on_cpu(monkeypatch, backend, want):
    """CPU interprets, the GPU compiles, anything else raises (no silent
    interpreter fallback on a device)."""
    monkeypatch.setattr(platform, "backend", lambda: backend)
    if want is None:
        with pytest.raises(RuntimeError):
            platform.pallas_interpret_default()
    else:
        assert platform.pallas_interpret_default() is want


def test_compile_cache_env_left_to_jax(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the code sets no directory."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert platform.enable_compilation_cache() == "/some/cache"
    assert calls == []


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = platform.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", got) in calls


LOWER_CASES = {
    "causal_gqa": dict(H=4, Hkv=2, D=128, kw=dict(causal=True)),
    "cross_d40": dict(H=4, Hkv=4, D=40, Nk=77, kw={}),
    "d256": dict(H=2, Hkv=2, D=256, kw=dict(causal=True)),
    "window_softcap": dict(H=4, Hkv=2, D=64,
                           kw=dict(causal=True, window=(31, 0),
                                   logit_softcap=30.0)),
    "segments": dict(H=4, Hkv=2, D=64, kw=dict(
        causal=True, segment_ids=jnp.zeros((1, 256), jnp.int32))),
    "bias_full": dict(H=4, Hkv=4, D=64,
                      bias=jnp.zeros((1, 4, 256, 256)), kw={}),
    "bias_rows1": dict(H=4, Hkv=4, D=64,
                       bias=jnp.zeros((1, 1, 1, 256)), kw={}),
    "fp16_traced_offset": dict(H=4, Hkv=4, D=64, dtype=jnp.float16,
                               kw=dict(causal=True, q_offset=jnp.int32(3))),
    "f32": dict(H=2, Hkv=2, D=64, dtype=jnp.float32, kw=dict(causal=True)),
}


@pytest.mark.parametrize("case", sorted(LOWER_CASES))
def test_kernels_lower_to_triton(case):
    """Forward + backward lower to three named Triton custom calls for the
    CUDA platform — the Pallas-level lowering the card's compiler takes."""
    c = LOWER_CASES[case]
    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, c["H"], 256, c["D"],
                       Nk=c.get("Nk"), Hkv=c["Hkv"],
                       dtype=c.get("dtype", jnp.bfloat16))
    bias = c.get("bias")
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)

    def loss(q, k, v, b):
        o = flash_attention(q, k, v, bias=b, interpret=False, **c["kw"])
        return o.astype(jnp.float32).sum()

    text = jax.jit(jax.grad(loss, argnums)).trace(q, k, v, bias).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 3
    names = set(re.findall(r'name = "(flash_[a-z]+)"', text))
    assert names == {"flash_fwd", "flash_dkv", "flash_dq"}, names


@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantized_kernel_lowers_to_triton(qdtype):
    q, k, v = make_qkv(jax.random.PRNGKey(0), 2, 8, 1, 128, Nk=1000, Hkv=2,
                       dtype=jnp.bfloat16)
    qkv = quantize_kv(k, v, qdtype)
    text = jax.jit(lambda q, qkv: flash_attention_quantized(
        q, qkv, interpret=False)).trace(q, qkv).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
