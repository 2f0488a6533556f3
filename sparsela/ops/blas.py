"""Fused multi-RHS BLAS-1 ops for the blocked CG solvers.

Capability parity with ``dot_multiple`` / ``axpy_multiple`` /
``update_p_multiple`` (``work_2025/cg/utils_multiple.hpp:9-61``)
and their single-vector forms (``work_2025/main/single_strategy.hpp:61-103``).

The reference fuses the L-RHS lane loop with ``#pragma omp simd`` over a
row-major interleaved [n, L] layout; here XLA fuses the elementwise
chains, so these are thin jnp expressions kept as named ops for API
parity. fp64 reductions are plain IEEE f64 sums.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot_multiple(a, b):
    """Per-RHS dot products: a, b (n, L) -> (L,).

    Parity: dot_multiple (cg/utils_multiple.hpp:9-26) — blocked
    omp-reduction over rows; here one column-wise reduction."""
    return jnp.sum(a * b, axis=0)


def axpy_multiple(y, alpha, x):
    """y += alpha[None, :] * x with per-RHS alpha (L,), arrays (n, L).

    Parity: axpy_multiple (cg/utils_multiple.hpp:28-43)."""
    return y + alpha[None, :] * x


def update_p_multiple(r, beta, p):
    """p = r + beta[None, :] * p with per-RHS beta (L,).

    Parity: update_p_multiple (cg/utils_multiple.hpp:45-61)."""
    return r + beta[None, :] * p


def dot_single(a, b):
    """Parity: DotSingle (single_strategy.hpp:61). Real-valued
    operands only."""
    return jnp.sum(a * b, axis=0)


def axpy_single(y, alpha, x):
    """Parity: AxpySingle (single_strategy.hpp:76)."""
    return y + alpha * x


def update_p_single(r, beta, p):
    """Parity: UpdatePSingle (single_strategy.hpp:90)."""
    return r + beta * p
