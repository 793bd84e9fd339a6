"""flashattn_tpu — a FlashAttention-2 engine for NVIDIA Hopper in JAX/Pallas.

Capability parity target: Repeerc/flash-attention-v2-RDNA3-minimal (see SURVEY.md).
Where the reference ships HIP C++ WMMA kernels wrapped in torch autograd
(rocwmma_fattn/kernel_fp16.cu, kernel_bf16.cu, FlashAttn.py), this package ships
Pallas kernels compiled through Triton, wrapped in ``jax.custom_vjp``, plus the
distribution layer the reference lacks (head-parallel, ring attention, Ulysses)
built on ``jax.shard_map`` and XLA collectives (NCCL).

Public API::

    from flashattn_tpu import flash_attention, scaled_dot_product_attention

    o = flash_attention(q, k, v, causal=True)                 # [B,H,N,D]
    o = flash_attention(q, k, v, layout="BNHD", bias=bias)    # [B,N,H,D], additive bias
    o = scaled_dot_product_attention(q, k, v, is_causal=True) # torch-SDPA style adapter
"""

from flashattn_tpu.ops.flash import (
    BlockSizes,
    flash_attention,
    flash_attention_with_lse,
)
from flashattn_tpu.ops.sdpa import scaled_dot_product_attention
from flashattn_tpu.ops.oracle import attention_reference

__version__ = "0.1.0"

__all__ = [
    "BlockSizes",
    "flash_attention",
    "flash_attention_with_lse",
    "scaled_dot_product_attention",
    "attention_reference",
    "__version__",
]
