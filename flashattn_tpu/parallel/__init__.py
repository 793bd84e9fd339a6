"""Distribution layer: mesh helpers, head-parallel, ring attention, Ulysses.

The reference has no distributed layer at all (SURVEY.md §2.5) — its
parallelism is the single-GPU kernel grid. This package scales the same
kernels over a `jax.sharding.Mesh` via `shard_map`; XLA hands the
collectives to NCCL.
"""

from flashattn_tpu.parallel.mesh import make_mesh
from flashattn_tpu.parallel.head_parallel import head_parallel_attention
from flashattn_tpu.parallel.ring import ring_attention, ring_attention_sharded
from flashattn_tpu.parallel.ulysses import ulysses_attention
from flashattn_tpu.parallel.zigzag import (
    zigzag_ring_attention,
    zigzag_ring_attention_sharded,
    zigzag_shard,
    zigzag_unshard,
)

__all__ = [
    "make_mesh",
    "head_parallel_attention",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "zigzag_ring_attention",
    "zigzag_ring_attention_sharded",
    "zigzag_shard",
    "zigzag_unshard",
]
