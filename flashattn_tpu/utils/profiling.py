"""Profiling & trace capture — the reference's tracing toolkit, in JAX.

Role parity (SURVEY.md §5):
  * ``RGP_Capture.py`` (runs single fwd/bwd invocations under Radeon GPU
    Profiler) → :func:`trace` / :func:`capture_attention_trace`, which wrap
    ``jax.profiler`` and emit a Perfetto/TensorBoard trace directory;
  * ``-save-temps`` ISA retention (reference FlashAttn.py:28) →
    :func:`dump_kernel_ir`, which saves the lowered StableHLO text (with the
    Triton kernels embedded) for
    a jitted function so generated code can be inspected offline;
  * the commented ``torch.autograd.profiler`` blocks in every bench →
    :func:`annotate`, a ``TraceAnnotation`` context for labeling bench regions.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/flashattn_tpu_trace", *, host: bool = False):
    """Capture a device trace around a code region.

    View with TensorBoard's profile plugin or Perfetto (the analogue of a
    Radeon GPU Profiler capture). Usage::

        with trace("/tmp/tr"):
            flash_attention(q, k, v).block_until_ready()
    """
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region in the captured trace (TraceAnnotation context)."""
    return jax.profiler.TraceAnnotation(name)


def dump_kernel_ir(fn, *example_args, out_dir: str = "/tmp/flashattn_tpu_ir",
                   name: str = "kernel", **kwargs) -> dict:
    """Save the lowered StableHLO and (when compiled) optimized HLO of
    ``fn(*example_args)`` — the ``-save-temps`` role: keep the generated
    "ISA" (here: compiler IR) for inspection.

    Returns {"stablehlo": path, "hlo": path | None}.
    """
    os.makedirs(out_dir, exist_ok=True)
    lowered = jax.jit(fn).lower(*example_args, **kwargs)
    paths = {}
    p = os.path.join(out_dir, f"{name}.stablehlo.txt")
    with open(p, "w") as f:
        f.write(lowered.as_text())
    paths["stablehlo"] = p
    try:
        compiled = lowered.compile()
        p = os.path.join(out_dir, f"{name}.hlo.txt")
        with open(p, "w") as f:
            f.write(compiled.as_text())
        paths["hlo"] = p
    except Exception:
        paths["hlo"] = None
    return paths


def capture_attention_trace(
    out_dir: str = "/tmp/flashattn_tpu_trace",
    *,
    B: int = 1, H: int = 24, N: int = 4096, D: int = 128,
    causal: bool = False, with_bwd: bool = True,
) -> str:
    """One-shot capture of fused attention fwd (+ bwd) — RGP_Capture.py's
    exact role (it runs single kernel invocations for the profiler,
    RGP_Capture.py:52-97)."""
    import jax.numpy as jnp

    from flashattn_tpu import flash_attention
    from flashattn_tpu.utils.testing import make_qkv

    q, k, v = make_qkv(jax.random.PRNGKey(0), B, H, N, D, dtype=jnp.bfloat16)

    fwd = jax.jit(lambda q, k, v: flash_attention(q, k, v, causal=causal))
    loss = jax.jit(jax.grad(
        lambda q, k, v: flash_attention(q, k, v, causal=causal)
        .astype(jnp.float32).sum(), argnums=(0, 1, 2)))

    # warm up (compile outside the trace so the capture is pure device work)
    fwd(q, k, v)[0].block_until_ready()
    if with_bwd:
        jax.block_until_ready(loss(q, k, v))

    with trace(out_dir):
        with annotate("flash_fwd"):
            fwd(q, k, v).block_until_ready()
        if with_bwd:
            with annotate("flash_bwd"):
                jax.block_until_ready(loss(q, k, v))
    return out_dir
