"""Checkpoint / resume for model + optimizer pytrees.

The reference has no checkpointing (SURVEY.md §5: stateless op library); this
framework ships model families and a sharded training step, so durable
train-state snapshots are part of the capability surface. Orbax is the
JAX-native store (async-capable, sharding-aware); a plain-numpy ``.npz``
fallback keeps the API working where orbax is unavailable.

    from flashattn_tpu.utils import checkpoint as ckpt
    ckpt.save(path, {"params": params, "opt": opt, "step": 100})
    state = ckpt.restore(path)                # or restore(path, like=state0)
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def _orbax():
    try:
        import orbax.checkpoint as ocp

        return ocp
    except Exception:
        return None


def save(path: str, state, *, force: bool = True) -> str:
    """Write ``state`` (any pytree of arrays/scalars) to ``path``."""
    path = os.path.abspath(path)
    ocp = _orbax()
    if ocp is not None:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, state, force=force)
        ckptr.wait_until_finished()
        return path
    # fallback: flatten to npz
    leaves, treedef = jax.tree_util.tree_flatten(state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", treedef=np.frombuffer(
        repr(treedef).encode(), dtype=np.uint8),
        **{f"leaf{i}": np.asarray(l) for i, l in enumerate(leaves)})
    return path + ".npz"


def restore(path: str, *, like=None):
    """Read a checkpoint. ``like``: a pytree of the same structure (required
    for the npz fallback and for sharded/dtype-exact orbax restores)."""
    path = os.path.abspath(path)
    ocp = _orbax()
    if ocp is not None and os.path.isdir(path):
        ckptr = ocp.StandardCheckpointer()
        if like is not None:
            target = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype)
                if hasattr(x, "dtype") else x, like)
            return ckptr.restore(path, target)
        return ckptr.restore(path)
    npz = path if path.endswith(".npz") else path + ".npz"
    if like is None:
        raise ValueError("npz fallback restore requires `like=`")
    data = np.load(npz)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    n_saved = sum(1 for k in data.files if k.startswith("leaf"))
    if n_saved != len(leaves):
        raise ValueError(
            f"checkpoint {npz} holds {n_saved} leaves but `like` has "
            f"{len(leaves)} — structure mismatch")
    new = []
    for i, ref in enumerate(leaves):
        leaf = data[f"leaf{i}"]
        ref_shape = np.shape(ref)
        if tuple(leaf.shape) != tuple(ref_shape):
            raise ValueError(
                f"checkpoint leaf {i}: saved shape {leaf.shape} != "
                f"`like` shape {ref_shape}")
        if hasattr(ref, "dtype"):
            leaf = jnp.asarray(leaf, dtype=ref.dtype)
        new.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, new)


def latest_step_dir(root: str) -> str | None:
    """Return the highest-numbered subdirectory of ``root`` (step layout
    ``root/<step>/``), or None. Convention for resumable training loops."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))
