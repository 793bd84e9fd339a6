"""Testing helpers: input generation, explicit per-dtype tolerances.

Role parity: the reference's precision tests *print* max-abs diffs and rely on
eyeballing (precision_test.py:66-98 — "no asserts", SURVEY.md §4). This module
formalizes that: pinned tolerances per dtype, oracle-relative (the Pallas
kernels accumulate in f32, so they are *more* accurate than the reference's
fp16-LDS kernels; tolerances are set vs the exact-softmax oracle).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Tolerance(NamedTuple):
    atol: float
    rtol: float


# Error budgets vs the f32 exact oracle, sized from the dtype's round-off on
# O(1) attention outputs. The adversarial reference shape (B3 H7 N1537 D111
# Nkv1234 bf16, precision_test.py:34-38) passes these.
#  * bf16: 8 mantissa bits; P and dS are rounded to bf16 before their
#    products, and outputs/gradients are stored in bf16.
#  * fp16 runs natively (10 mantissa bits), so its budget is 4× tighter.
#  * f32: the kernels' products run as six bf16 passes (f32-class, not
#    TF32); the error is f32 round-off of the products, the online softmax
#    and summation order, ~1e-6 on these shapes. 1e-4 leaves room for
#    longer sequences while staying 200× tighter than bf16.
FWD_TOL = {
    jnp.float32.dtype: Tolerance(1e-4, 1e-4),
    jnp.bfloat16.dtype: Tolerance(2e-2, 2e-2),
    jnp.float16.dtype: Tolerance(5e-3, 5e-3),
}
# Gradients amplify round-off via the dS = P(dP - D) cancellation; budgets are
# looser, matching what the reference's printed diffs show for its own kernels.
BWD_TOL = {
    jnp.float32.dtype: Tolerance(1e-3, 5e-4),
    jnp.bfloat16.dtype: Tolerance(8e-2, 8e-2),
    jnp.float16.dtype: Tolerance(2e-2, 2e-2),
}


def make_qkv(
    key,
    B: int,
    H: int,
    Nq: int,
    D: int,
    *,
    Nk: int | None = None,
    Hkv: int | None = None,
    dtype=jnp.float32,
):
    """Random Q/K/V in `[B,H,N,D]`, unit-scale normal (reference tests use randn)."""
    Nk = Nq if Nk is None else Nk
    Hkv = H if Hkv is None else Hkv
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (B, H, Nq, D), dtype=jnp.float32).astype(dtype)
    k = jax.random.normal(kk, (B, Hkv, Nk, D), dtype=jnp.float32).astype(dtype)
    v = jax.random.normal(kv, (B, Hkv, Nk, D), dtype=jnp.float32).astype(dtype)
    return q, k, v


def check_close(actual, expected, tol: Tolerance, name: str = "out"):
    """Per-element ``|a−e| ≤ atol + rtol·|e|`` check (the numpy.allclose
    criterion — no whole-tensor OR-escape where a large-magnitude systematic
    error passes on rtol alone). Returns (ok, message)."""
    a = np.asarray(actual, dtype=np.float32)
    e = np.asarray(expected, dtype=np.float32)
    if a.shape != e.shape:
        return False, f"{name}: shape {a.shape} != {e.shape}"
    if a.size == 0:
        return True, f"{name}: empty"
    err = np.abs(a - e)
    budget = tol.atol + tol.rtol * np.abs(e)
    excess = err - budget
    worst = int(np.argmax(excess))
    ok = bool(excess.flat[worst] <= 0.0)
    msg = (
        f"{name}: max_abs_err={err.max():.3e}, worst element "
        f"|a−e|={err.flat[worst]:.3e} vs budget {budget.flat[worst]:.3e} "
        f"(atol {tol.atol:.1e} + rtol {tol.rtol:.1e}·|e|, "
        f"e={e.flat[worst]:.3e}) at flat index {worst}"
    )
    return ok, msg


def assert_close(actual, expected, tol: Tolerance, name: str = "out"):
    """Assert per-element ``|a−e| ≤ atol + rtol·|e|``."""
    ok, msg = check_close(actual, expected, tol, name)
    assert ok, msg


def grad_gate(grads, grads_want, tol: Tolerance,
              names=("dq", "dk", "dv")):
    """Per-element gate over a tuple of gradient tensors. Returns
    ``(ok, why, grad_maxdiff, grad_maxrel)`` — the maxdiff/maxrel fields are
    reported for continuity with the reference's printed diffs
    (precision_test.py:66-98); the pass/fail decision is per-element."""
    gmd = gmr = 0.0
    ok, why = True, ""
    for name, a, b in zip(names, grads, grads_want):
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        d = np.abs(a - b)
        gmd = max(gmd, float(d.max()))
        gmr = max(gmr, float((d / np.maximum(np.abs(b), 1.0)).max()))
        gok, msg = check_close(a, b, tol, name)
        if not gok:
            ok, why = False, (why + "; " + msg if why else msg)
    return ok, why, gmd, gmr
