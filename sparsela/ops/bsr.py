"""BCSR (block-sparse row) SpMV/SpMM in plain XLA.

Capability parity with the reference's BCSR format
(``sparse_matrix.h:993-1258``): every stored block is a
dense (block_rows x block_cols) panel, so the per-block product is a
small dense contraction. Gather the x blocks the block columns name,
contract each panel with its x block in one batched ``einsum``, then
``segment_sum`` the partial panels over block rows.

``precision=HIGHEST`` keeps f32 contractions out of TF32, whose ~1e-3
relative rounding would break agreement with the CSR routes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def _block_row_ids(bcsr):
    nb = bcsr.block_col_indices.shape[0]
    return (
        jnp.searchsorted(
            bcsr.block_row_offsets,
            jnp.arange(nb, dtype=bcsr.block_row_offsets.dtype),
            side="right",
        )
        - 1
    ).astype(jnp.int32)


@jax.jit
def bsr_matmat(bcsr, X):
    """A @ X for a device BcsrMatrix and X (num_cols, L) ->
    (num_rows, L)."""
    br, bc = bcsr.block_rows, bcsr.block_cols
    L = X.shape[1]
    nbc = -(-bcsr.num_cols // bc)
    Xp = jnp.zeros((nbc * bc, L), dtype=bcsr.blocks.dtype)
    Xp = Xp.at[: bcsr.num_cols].set(X.astype(bcsr.blocks.dtype))
    Xg = jnp.take(Xp.reshape(nbc, bc, L), bcsr.block_col_indices,
                  axis=0)                                   # (nb, bc, L)
    contrib = jnp.einsum("bij,bjl->bil", bcsr.blocks, Xg,
                         precision=_HIGHEST)                # (nb, br, L)
    nbr = -(-bcsr.num_rows // br)
    Yp = jax.ops.segment_sum(contrib, _block_row_ids(bcsr),
                             num_segments=nbr, indices_are_sorted=True)
    return Yp.reshape(-1, L)[: bcsr.num_rows]
