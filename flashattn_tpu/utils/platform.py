"""Backend detection, Pallas execution mode and the compile cache.

Role parity: the reference gates its build/run path per platform
(rocwmma_fattn/FlashAttn.py:7-16 picks ZLUDA vs ROCm and pins the GPU arch).
Here the decision is "compile the Pallas kernels for the GPU (Triton route)
or run them in interpreter mode on the CPU (tests)". There is no silent
fallback: any other backend is an error.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def backend() -> str:
    return jax.default_backend()


def pallas_interpret_default() -> bool:
    """Whether Pallas kernels run in interpreter mode: on the CPU backend
    (tests) they do; on the GPU they compile; any other backend raises."""
    b = backend()
    if b == "cpu":
        return True
    if b in ("gpu", "cuda"):
        return False
    raise RuntimeError(
        f"no kernel route for backend {b!r}: the kernels compile for NVIDIA "
        "GPUs and run interpreted on the CPU")


def enable_compilation_cache(*, min_compile_secs: float = 1.0) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and nothing is set here. Otherwise the cache lives at the
    fixed ``<checkout>/.jax_cache`` (a fixed path: the path is part of the
    cache key). Must run before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return CACHE_DIR


def device_record() -> dict:
    """What a measurement ran on: JAX's device (platform, kind, count) and
    the card's name and power limit as ``nvidia-smi`` reports them (a card
    set below its maximum power runs slower under load)."""
    import subprocess

    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "unavailable"
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}
