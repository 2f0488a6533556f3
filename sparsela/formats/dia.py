"""DIA (diagonal) format — the dense structure stencil matrices have.

The reference's BCSR format (``sparse_matrix.h:993-1258``)
captures *block*-dense substructure; its grid2d/grid3d fixtures
(``sparse_matrix.h:458-623``), however, are banded: every nonzero sits
on one of a handful of constant diagonals (7 for the 3-D Laplacian).
The dense structure worth exploiting there is the *diagonal run*:

    y[i] += d_k[i] * x[i + off_k]

is a shifted elementwise FMA — unit-stride streams, zero gathers, no
index traffic — and XLA fuses all K diagonals into one pass over the
vectors (``ops.dia``).

``select_diagonals`` + ``partition_dia`` split any CSR into a DIA part
and a scattered remainder for a CSR plan; y-accumulation is
order-independent so summing the two paths is exact. ``ops.hybrid``
wraps the pair; ``ops.spmv.plan_matrix`` AUTO-gates on coverage.

Layout: row-aligned DIA (scipy.sparse.dia_matrix convention transposed
to row index): ``data[k, i] = A[i, i + offsets[k]]``, zero-filled where
out of range, so the apply needs no bounds masking.

Masked form: when every diagonal is a constant coefficient wherever it
is populated (``plane_constants``) — every constant-coefficient stencil
is — the K value planes compress to ONE int32 bitmask word per row
(bit k = plane k populated) plus K coefficients. The per-element
coefficient ``bit ? c_k : 0`` IS the stored plane value, so the two
forms give identical results while the plane traffic drops from
K * itemsize to 4 bytes per row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp


# Occupancy a diagonal needs before it moves to the DIA path: a value
# plane streams num_rows slots of 4-8 B where CSR streams 8-12 B per
# stored entry, so at a quarter occupancy the plane moves no more
# bytes than CSR does for the same entries (and the masked form pays
# nothing per plane at all).
MIN_OCCUPANCY = 0.25
MAX_DIAGS = 64

# The masked form packs one bit per plane into an int32 word per row.
MASK_MAX_PLANES = 32


@dataclasses.dataclass
class DiaHost:
    """Host-side DIA plan: ``data[k, i] = A[i, i + offsets[k]]``."""

    num_rows: int
    num_cols: int
    offsets: np.ndarray   # (K,) int64, sorted
    data: np.ndarray      # (K, num_rows), zero where out of range

    @property
    def nnz_slots(self) -> int:
        return int(self.data.size)


def diagonal_profile(csr):
    """(offsets, counts, lengths) for every populated diagonal
    ``off = col - row``; lengths are the in-bounds run lengths."""
    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    n, m = csr.num_rows, csr.num_cols
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    off = ci - rows
    counts = np.bincount(off + n - 1, minlength=n + m - 1)
    offsets = np.flatnonzero(counts) - (n - 1)
    counts = counts[offsets + n - 1]
    lengths = np.minimum(n, m - offsets) - np.maximum(0, -offsets)
    return offsets, counts, lengths


def select_diagonals(csr, min_occ: float = MIN_OCCUPANCY,
                     max_diags: int = MAX_DIAGS) -> np.ndarray:
    """Offsets worth moving to the DIA path: occupancy >= ``min_occ``,
    highest-count first, at most ``max_diags``. Sorted ascending.

    Occupancy is counted against ``num_rows`` — the *plane* cost — not
    the diagonal's in-bounds length: a DIA plane streams num_rows slots
    regardless of how short the run is, so a 3-entry corner diagonal
    must not be selected just because its run is fully occupied."""
    offsets, counts, _lengths = diagonal_profile(csr)
    occ = counts / max(csr.num_rows, 1)
    keep = occ >= min_occ
    offsets, counts = offsets[keep], counts[keep]
    if offsets.size > max_diags:
        top = np.argsort(counts)[::-1][:max_diags]
        offsets = offsets[top]
    return np.sort(offsets)


def partition_dia(csr, offsets):
    """Split ``csr`` into (DiaHost over ``offsets``, remainder CsrMatrix).

    Every entry whose ``col - row`` is in ``offsets`` lands in the DIA
    data planes (duplicates accumulate, matching CSR semantics);
    everything else keeps CSR order in the remainder."""
    from sparsela.formats.csr import CsrMatrix

    ro = np.asarray(csr.row_offsets).astype(np.int64)
    ci = np.asarray(csr.col_indices).astype(np.int64)
    va = np.asarray(csr.values)
    n, m = csr.num_rows, csr.num_cols
    offsets = np.sort(np.asarray(offsets, dtype=np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    off = ci - rows

    if offsets.size:
        pos_c = np.minimum(np.searchsorted(offsets, off),
                           offsets.size - 1)
        on_dia = offsets[pos_c] == off
    else:
        pos_c = np.zeros(off.shape, dtype=np.int64)
        on_dia = np.zeros(off.shape, dtype=bool)

    data = np.zeros((offsets.size, n), dtype=va.dtype)
    np.add.at(data, (pos_c[on_dia], rows[on_dia]), va[on_dia])

    keep = ~on_dia
    counts = np.bincount(rows[keep], minlength=n)
    new_ro = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ro[1:])
    rest = CsrMatrix(n, m, new_ro, ci[keep].astype(np.int32),
                     va[keep].copy())
    return DiaHost(n, m, offsets, data), rest


def plane_constants(data: np.ndarray):
    """Per-plane two-valued detection for masked-DIA compression.

    Returns ``(vals, ok)``: ``ok[k]`` is True when plane k's value
    alphabet is exactly ``{0, vals[k]}`` — i.e. the diagonal is a
    CONSTANT coefficient wherever it is populated (structural zeros
    and boundary gaps are the 0s). Every constant-coefficient stencil
    operator (the reference's grid2d/grid3d fixtures,
    ``sparse_matrix.h:458-623``) satisfies this on all
    planes. Empty planes report ok=True, vals=0."""
    K = data.shape[0]
    vals = np.zeros(K, dtype=np.float64)
    ok = np.ones(K, dtype=bool)
    for k in range(K):
        plane = data[k]
        nz = plane[plane != 0]
        if nz.size:
            vals[k] = nz[0]
            ok[k] = bool((nz == nz[0]).all())
    return vals, ok


def maskable(dia: DiaHost) -> bool:
    """True when the plan compresses to the exact masked form."""
    if len(dia.offsets) > MASK_MAX_PLANES:
        return False
    return bool(plane_constants(dia.data)[1].all())


def mask_words(dia: DiaHost) -> np.ndarray:
    """(n,) int32 validity words: bit k = plane k populated at that
    row. THE one bit-layout definition — the single-device masked
    apply (``ops.dia``) and the sharded masked form
    (``parallel.sharded_dia``) both read these words with
    ``(m >> k) & 1``."""
    K = dia.offsets.shape[0]
    if K > MASK_MAX_PLANES:
        raise ValueError(f"masked DIA holds at most {MASK_MAX_PLANES} "
                         f"planes, got {K}")
    w = np.zeros(dia.num_rows, dtype=np.uint32)
    for k in range(K):
        w |= (dia.data[k] != 0).astype(np.uint32) << np.uint32(k)
    return w.view(np.int32)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DiaDevice:
    """Device DIA operand: static offsets plus either

    * value planes ``data`` (K, num_rows) — f32, f64, or bf16 storage
      (bf16 planes are upcast and the arithmetic runs in f32), or
    * the masked form: ``mask`` (num_rows,) int32 bit words and
      ``coef`` (K,) per-plane coefficients in the plan dtype.

    Exactly one of ``data`` / ``mask`` is set."""

    num_rows: int
    num_cols: int
    offsets: tuple          # static python ints
    data: Any = None        # (K, num_rows) planes, or None
    mask: Any = None        # (num_rows,) int32, or None
    coef: Any = None        # (K,) coefficients of the masked form

    def tree_flatten(self):
        return (
            (self.data, self.mask, self.coef),
            (self.num_rows, self.num_cols, self.offsets),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def masked(self) -> bool:
        return self.mask is not None

    @property
    def dtype(self):
        """Arithmetic dtype: bf16 planes compute in f32."""
        stored = self.coef.dtype if self.masked else self.data.dtype
        return jnp.promote_types(stored, jnp.float32)

    @property
    def storage_dtype(self):
        return self.coef.dtype if self.masked else self.data.dtype

    @property
    def nnz(self) -> int:
        # informational: slots, not real nnz
        return len(self.offsets) * self.num_rows


def to_device_dia(dia: DiaHost, dtype=None, plane_dtype=None,
                  masked: bool | None = None) -> DiaDevice:
    """Ship a host DIA plan at the requested dtype (fp64 needs x64).

    ``masked=None`` compresses constant-coefficient operators to the
    bitmask form (exact); ``False`` forces value planes, ``True``
    raises when a plane is not two-valued. ``plane_dtype`` stores the
    value planes in a narrower type (bf16) than the arithmetic dtype;
    it forces the value-plane form."""
    dtype = np.dtype(dtype or dia.data.dtype)
    if dtype.itemsize > 4 and not jax.config.jax_enable_x64:
        raise TypeError(
            "fp64 DIA requires jax_enable_x64=True (the value planes "
            "would silently truncate to f32 otherwise)"
        )
    offsets = tuple(int(o) for o in dia.offsets)
    if plane_dtype is not None:
        if masked:
            raise ValueError("narrow planes apply to the value-plane "
                             "form only")
        masked = False
    if masked is None:
        masked = maskable(dia)
    elif masked and not maskable(dia):
        raise ValueError(
            "masked DIA requires every diagonal to be a constant "
            "coefficient (formats.dia.plane_constants)")
    if masked:
        vals, _ = plane_constants(dia.data)
        return DiaDevice(dia.num_rows, dia.num_cols, offsets,
                         mask=jnp.asarray(mask_words(dia)),
                         coef=jnp.asarray(vals.astype(dtype)))
    planes = dia.data.astype(dtype)
    if plane_dtype is not None:
        # rounding on the host: numpy's ml_dtypes bf16 cast is
        # round-to-nearest-even, identical to the device cast
        planes = planes.astype(np.dtype(plane_dtype))
    return DiaDevice(dia.num_rows, dia.num_cols, offsets,
                     data=jnp.asarray(planes))
