"""DIA SpMV/SpMM — shifted elementwise FMAs, the stream-bound path.

For each stored diagonal ``off``: ``y[i] += c_k[i] * x[i + off]``.
With x zero-padded by the offset range, every diagonal is a *static*
slice of the padded vector, so the whole SpMV is K unrolled
multiply-adds over unit-stride streams that XLA fuses into one loop:
no gathers, no index traffic, bound by memory bandwidth.

``c_k`` is either the stored value plane (f32, f64, or bf16 storage —
bf16 planes are upcast and the arithmetic runs in f32) or, for the
masked form, ``((mask >> k) & 1) ? coef[k] : 0`` — one int32 word per
row instead of K planes, with identical values (``formats.dia``).

Reference capability this accelerates: the grid2d/grid3d stencil
fixtures (``sparse_matrix.h:458-623``) under the SpMV
drivers (``cpu_spmv.cpp:750-923``); correctness is defined by
``SpmvGold`` (``work_2025/spmm/sample.hpp:14-34``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sparsela.formats.dia import DiaDevice


def _pads(D: DiaDevice) -> tuple[int, int]:
    offs = D.offsets
    pad_lo = max(0, -min(offs)) if offs else 0
    pad_hi = max(0, (max(offs) if offs else 0)
                 + D.num_rows - D.num_cols)
    return pad_lo, pad_hi


def _coef(D: DiaDevice, k: int):
    """Per-row coefficient of diagonal k, (num_rows,), arithmetic dtype."""
    if D.masked:
        return jnp.where(((D.mask >> k) & 1) != 0, D.coef[k],
                         jnp.zeros((), D.coef.dtype))
    return D.data[k].astype(D.dtype)


@jax.jit
def _spmm_dia_t(D: DiaDevice, XT):
    """Transposed-layout core: XT (L, num_cols) -> (L, num_rows).

    Rows are the minor (contiguous) axis, so every shifted slice is a
    unit-stride stream for any L."""
    n = D.num_rows
    pad_lo, pad_hi = _pads(D)
    Xp = jnp.pad(XT.astype(D.dtype), ((0, 0), (pad_lo, pad_hi)))
    acc = jnp.zeros((XT.shape[0], n), D.dtype)
    for k, off in enumerate(D.offsets):
        sl = jax.lax.slice_in_dim(Xp, off + pad_lo, off + pad_lo + n,
                                  axis=1)
        acc = acc + _coef(D, k)[None, :] * sl
    return acc


def spmm_dia_t(D: DiaDevice, XT):
    """Transposed-layout SpMM: XT (L, num_cols) -> A@X as (L, num_rows)
    with no boundary transposes (the multi-RHS solvers keep their
    state in this layout)."""
    return _spmm_dia_t(D, XT)


def _scale(y_new, alpha, beta, y):
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y


def spmm_dia(D: DiaDevice, X, alpha=1.0, beta=0.0, Y=None):
    """Y = alpha * A @ X + beta * Y, X of shape (num_cols, L)."""
    return _scale(_spmm_dia_t(D, X.T).T, alpha, beta, Y)


def spmv_dia(D: DiaDevice, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha * A @ x + beta * y."""
    return _scale(_spmm_dia_t(D, x[None, :])[0], alpha, beta, y)
