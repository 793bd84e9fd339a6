"""Benchmark harness: device timing + FLOPs accounting.

Role parity: the reference's per-bench ``count_time`` decorator (warm-up
rounds, then timed rounds around ``torch.cuda.synchronize``, TFLOPS from an
explicit FLOPs model — bench_with_sdpa.py:14-49, 35-41). Here the
synchronization is ``jax.block_until_ready``: JAX returns before the device
finishes, so every timed window ends in it, and nothing else is needed.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np


def time_chained_stats(
    step: Callable,
    carry0,
    *,
    consts=(),
    iters: int = 64,
    warmup_iters: int = 8,
    repeats: int = 5,
) -> dict:
    """Per-iteration timing statistics of ``carry = step(carry, *consts)``.

    ``step`` is jitted and called ``iters`` times per sample, each call
    taking the previous output (a data dependency, so calls run in order);
    the sample ends in ``block_until_ready``. ``warmup_iters`` calls (the
    first one compiles) are not timed. ``consts`` are loop-invariant jit
    arguments (weights, KV caches). Returns the median over ``repeats``
    samples with its spread:
    ``{"per_iter": median_s, "spread": (max−min)/median, "samples": [...]}``.
    """
    fn = jax.jit(step)
    carry = carry0
    for _ in range(max(1, warmup_iters)):
        carry = fn(carry, *consts)
    jax.block_until_ready(carry)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = fn(carry, *consts)
        jax.block_until_ready(carry)
        samples.append((time.perf_counter() - t0) / iters)
    med = max(float(np.median(samples)), 1e-12)
    return {
        "per_iter": med,
        "spread": (max(samples) - min(samples)) / med,
        "samples": [round(s, 9) for s in samples],
    }


def time_chained(
    step: Callable,
    carry0,
    *,
    consts=(),
    iters: int = 64,
    warmup_iters: int = 8,
    repeats: int = 5,
) -> float:
    """Median seconds/iteration — see :func:`time_chained_stats`."""
    return time_chained_stats(
        step, carry0, consts=consts, iters=iters,
        warmup_iters=warmup_iters, repeats=repeats,
    )["per_iter"]


def attention_flops(
    b: int, h: int, nq: int, nk: int, d: int, *, causal: bool, mode: str,
    window: tuple[int, int] | None = None,
) -> float:
    """Reference FLOPs model (bench_with_sdpa.py:35-41, 129-133):
    ``fpm = 2·B·H·Nq·Nk·D``; fwd = 2·fpm; bwd = 5·fpm; fwd+bwd = 7·fpm;
    ×0.5 when causal.

    ``window=(left, right)``: band-area accounting — ``Nq·Nk`` is replaced by
    the exact number of live (i, j) pairs of the band (row i attends to
    ``i−left ≤ j ≤ i+right``, ANDed with causal, clipped to ``[0, Nk)``).
    Same idea as the reference's causal halving, done exactly: a windowed
    kernel does band-area work, so quoting full-N² "TFLOP/s" would exceed
    the roofline at large N."""
    if window is not None:
        left, right = window
        i = np.arange(nq, dtype=np.int64)
        lo = i - left if left >= 0 else np.zeros_like(i)
        hi = i + right if right >= 0 else np.full_like(i, nk - 1)
        if causal:
            hi = np.minimum(hi, i)
        lo = np.clip(lo, 0, nk - 1)
        hi = np.clip(hi, -1, nk - 1)
        area = float(np.maximum(hi - lo + 1, 0).sum())
        fpm = 2.0 * b * h * area * d
        return fpm * {"fwd": 2.0, "bwd": 5.0, "fwd_bwd": 7.0}[mode]
    fpm = 2.0 * b * h * nq * nk * d
    mult = {"fwd": 2.0, "bwd": 5.0, "fwd_bwd": 7.0}[mode]
    f = mult * fpm
    return f * 0.5 if causal else f


def summarize(samples):
    """Mean/std/min/p50/p90 of timing samples."""
    arr = np.asarray(samples, dtype=np.float64)
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "p50": float(np.percentile(arr, 50, method="lower")),
        "p90": float(np.percentile(arr, 90, method="lower")),
    }
