"""Device identity and process set-up shared by the measuring entry
points (``bench.py``, ``chip_smoke.py``, the ``sparsela.bench.run``
CLI)."""

from __future__ import annotations

import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX already
    uses it and nothing is set here; otherwise the cache lives at the
    fixed path ``<repo>/.jax_cache`` (a fixed path, because the path is
    part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """Platform, kind and count of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it
    (a child process that stays off JAX), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def require_gpu() -> dict:
    """``device_info()`` when JAX's devices are GPUs; raises otherwise
    (a measurement never falls back to the CPU)."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found platform {info['platform']!r} — device "
            "metrics are only measured on the card")
    return info
