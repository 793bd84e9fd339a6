"""Mesh construction helpers.

Axis convention used across the package (models/, parallel/, chip_smoke.py):

  * ``data``  — batch (DP); gradients all-reduced across it.
  * ``model`` — attention heads / MLP columns (TP); zero-comm attention.
  * ``seq``   — sequence/context (SP); ring attention or Ulysses all-to-all.

The cards of one host are NVLink peers, all to all at one rate, so the mesh
follows the algorithm alone: devices fill it in ``jax.devices()`` order.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, *,
              devices=None) -> Mesh:
    """Build a ``(data, model, seq)`` mesh over the first
    ``data*model*seq`` devices."""
    if devices is None:
        devices = jax.devices()
    n = data * model * seq
    if n > len(devices):
        raise ValueError(
            f"mesh {data}x{model}x{seq}={n} exceeds {len(devices)} devices")
    arr = np.array(devices[:n]).reshape(data, model, seq)
    return Mesh(arr, axis_names=("data", "model", "seq"))
