"""Plan persistence: save/load tuned kernel plans.

The reference re-parses and re-plans every benchmark run (its drivers
call InitMarket + CsrMatrix::Init per invocation,
``cpu_spmv.cpp:750-790``); at production scale the
plan is the expensive artifact — .mtx parse + diagonal analysis +
reordering take seconds per matrix while a solve dispatch is
microseconds. ``save_plan``/``load_plan`` persist any planner output
(every plan type is a registered JAX pytree: CSR / cuSPARSE CSR / BCOO
/ DIA / hybrid / BSR / reordered), and
``cached_plan`` wraps ``ops.spmv.plan_matrix`` with a content-keyed
on-disk cache so repeated production runs skip planning entirely.

Format: a pickle of the plan object with every leaf pulled to host
numpy (version-tagged envelope with shape/strategy metadata). Load
pushes leaves back to the default device. Pickle is appropriate here
— these are local cache artifacts produced by the same library, not
an interchange format.
"""

from __future__ import annotations

import os
import pickle
import zlib

import numpy as np

# v5: the plan types themselves changed (flat masked DiaDevice, no
# tile/ELL/stream plans, ReorderedPlan without kernel payloads); older
# pickles are refused and re-planned.
_FORMAT_VERSION = 5
_MAGIC = "sparsela-plan"


def _to_host(plan):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x), plan)


def _to_device(plan):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, plan)


def save_plan(path, plan, extra_meta: dict | None = None) -> None:
    """Persist a planner output (any registered-pytree plan object) to
    ``path``. Leaves are pulled to host numpy; static metadata rides
    the pytree structure."""
    payload = {
        "magic": _MAGIC,
        "format": _FORMAT_VERSION,
        "class": type(plan).__name__,
        "meta": dict(extra_meta or {}),
        "plan": _to_host(plan),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic: concurrent readers never see a torn file


def load_plan(path, device: bool = True):
    """Load a plan saved by :func:`save_plan`. ``device=True`` pushes
    array leaves to the default JAX device (lazy — transfers happen on
    first use under jit)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a sparsela plan file")
    if payload.get("format") != _FORMAT_VERSION:
        raise ValueError(
            f"{path}: plan format {payload.get('format')} != "
            f"{_FORMAT_VERSION} (re-plan and re-save)")
    plan = payload["plan"]
    return _to_device(plan) if device else plan


def plan_info(path) -> dict:
    """Metadata of a saved plan without device transfers: class name,
    format version, and whatever extra_meta was recorded."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not a sparsela plan file")
    return {"class": payload["class"], "format": payload["format"],
            **payload["meta"]}


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def plan_cache_key(csr, **plan_kwargs) -> str:
    """Content key for ``cached_plan``: matrix shape + sparsity
    pattern CRCs + a values CRC + the planner kwargs. Collisions
    require matching CRC32s on three independent streams — acceptable
    for a local cache (and a stale hit still computes a *valid* SpMV
    for any matrix with identical pattern and values)."""
    parts = [
        f"{csr.num_rows}x{csr.num_cols}", f"nnz{csr.nnz}",
        f"ro{_crc(np.asarray(csr.row_offsets)):08x}",
        f"ci{_crc(np.asarray(csr.col_indices)):08x}",
        f"va{_crc(np.asarray(csr.values)):08x}",
    ]
    for k in sorted(plan_kwargs):
        v = plan_kwargs[k]
        if v is not None and hasattr(v, "__name__"):
            v = v.__name__
        parts.append(f"{k}={np.dtype(v).name if k == 'dtype' and v is not None else v}")
    return "-".join(parts)


def cached_plan(csr, cache_dir, **plan_kwargs):
    """``ops.spmv.plan_matrix`` with an on-disk cache: the first call
    for a given (matrix content, planner kwargs) builds and saves the
    plan; later calls — including from other processes — load it.

    Returns the plan. Cache files are content-addressed
    (:func:`plan_cache_key`), so edits to the matrix re-plan."""
    from sparsela.ops.spmv import plan_matrix

    os.makedirs(cache_dir, exist_ok=True)
    key = plan_cache_key(csr, **plan_kwargs)
    path = os.path.join(cache_dir, f"{key}.plan")
    if os.path.exists(path):
        try:
            return load_plan(path)
        except ValueError:
            pass  # stale format version: fall through and re-plan
    plan = plan_matrix(csr, **plan_kwargs)
    save_plan(path, plan, extra_meta={
        "rows": csr.num_rows, "cols": csr.num_cols, "nnz": csr.nnz,
        **{k: str(v) for k, v in plan_kwargs.items()},
    })
    return plan
