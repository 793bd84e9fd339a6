"""Profiler capture script — parity with the reference's RGP_Capture.py.

Runs single fused-attention fwd/bwd invocations under the JAX profiler and
writes a Perfetto/TensorBoard trace plus the lowered compiler IR.

  python benchmarks/capture_trace.py [--out chiprun_out/trace]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from flashattn_tpu.utils.platform import device_record, enable_compilation_cache

enable_compilation_cache()


def capture_ring_trace(out_dir: str, n_dev: int = 8):
    """Trace one ring-attention step on the available mesh (virtual CPU
    mesh when single-card). The fwd loop issues step s+1's KV ppermute
    BEFORE step s's kernels; on several cards the latency-hiding scheduler
    splits the permute into start/done around the compute — this capture
    is the artifact to check that on hardware (single-card traces show only
    the compute)."""
    import jax.numpy as jnp

    from flashattn_tpu.parallel import make_mesh, ring_attention_sharded
    from flashattn_tpu.utils import profiling
    from flashattn_tpu.utils.testing import make_qkv

    n = min(n_dev, jax.device_count())
    mesh = make_mesh(seq=n)
    fn = ring_attention_sharded(mesh, causal=True, batch_axis=None,
                                head_axis=None)
    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 4, 512 * n, 64,
                       dtype=jnp.float32)
    fn(q, k, v).block_until_ready()  # compile outside the capture
    with profiling.trace(out_dir):
        with profiling.annotate("ring_attention_step"):
            fn(q, k, v).block_until_ready()
    return out_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out", "trace"))
    ap.add_argument("--N", type=int, default=4096)
    ap.add_argument("--D", type=int, default=128)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--no-bwd", action="store_true")
    ap.add_argument("--ring", action="store_true",
                    help="trace a ring-attention step instead")
    args = ap.parse_args()
    print(device_record(), flush=True)

    if args.ring:
        out = capture_ring_trace(args.out)
        print(f"ring trace written to {out}")
        return

    from flashattn_tpu import flash_attention
    from flashattn_tpu.utils import profiling
    from flashattn_tpu.utils.testing import make_qkv

    out = profiling.capture_attention_trace(
        args.out, N=args.N, D=args.D, causal=args.causal,
        with_bwd=not args.no_bwd,
    )
    print(f"trace written to {out}")

    q, k, v = make_qkv(jax.random.PRNGKey(0), 1, 24, args.N, args.D,
                       dtype=jnp.bfloat16)
    paths = profiling.dump_kernel_ir(
        lambda q, k, v: flash_attention(q, k, v, causal=args.causal),
        q, k, v, out_dir=os.path.join(out, "ir"), name="flash_fwd")
    print(f"IR written: {paths}")


if __name__ == "__main__":
    main()
