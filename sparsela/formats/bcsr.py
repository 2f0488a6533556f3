"""BCSR (blocked CSR) sparse matrix.

Capability parity with the reference's ``BcsrMatrix``
(``sparse_matrix.h:993-1258``): CSR→BCSR conversion with a
two-pass count+fill, zero-padded dense blocks stored row-major within the
block. The reference requires dims divisible by block_dim and uses square
3x3 blocks; here blocks may be rectangular and the matrix is implicitly
zero-padded to block multiples. The dense blocks feed the batched
``einsum`` SpMV/SpMM of :mod:`sparsela.ops.bsr`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax


def fill_estimate(csr, block_rows: int = 8, block_cols: int = 128
                  ) -> float:
    """Blocking fill ratio WITHOUT building the blocks: nnz over the
    dense capacity of the touched (block_rows x block_cols) tiles.
    Cheap plan-time gate for the BSR strategy (ops.spmv AUTO)."""
    nnz = csr.nnz
    if nnz == 0:
        return 0.0
    ci = np.asarray(csr.col_indices).astype(np.int64)
    rows = csr.row_ids()
    key = (rows // block_rows) * (
        (csr.num_cols // block_cols) + 1
    ) + ci // block_cols
    num_blocks = np.unique(key).size
    return nnz / (num_blocks * block_rows * block_cols)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BcsrMatrix:
    """Blocked-CSR matrix: dense (br x bc) blocks in CSR block layout.

    Attributes:
      num_rows / num_cols: logical (unpadded) dims — static aux data.
      block_rows / block_cols: block shape — static aux data.
      block_row_offsets: (num_block_rows + 1,) int32.
      block_col_indices: (num_blocks,) int32 — block-column index.
      blocks: (num_blocks, block_rows, block_cols) values.
    """

    num_rows: int
    num_cols: int
    block_rows: int
    block_cols: int
    block_row_offsets: Any
    block_col_indices: Any
    blocks: Any

    def tree_flatten(self):
        return (
            (self.block_row_offsets, self.block_col_indices, self.blocks),
            (self.num_rows, self.num_cols, self.block_rows, self.block_cols),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def num_blocks(self) -> int:
        return int(self.block_col_indices.shape[0])

    @property
    def num_block_rows(self) -> int:
        return -(-self.num_rows // self.block_rows)

    @property
    def num_block_cols(self) -> int:
        return -(-self.num_cols // self.block_cols)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows, self.num_cols)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def fill_ratio(self) -> float:
        """Fraction of stored block entries that would be nonzero in CSR —
        the efficiency of the blocking for this sparsity pattern."""
        nz = int((np.asarray(self.blocks) != 0).sum())
        total = self.blocks.size
        return nz / total if total else 0.0

    @classmethod
    def from_csr(cls, csr, block_rows: int = 8, block_cols: int = 128):
        """Two-pass count+fill conversion (parity with ``BcsrMatrix::Init``,
        ``sparse_matrix.h:993-1258``), generalized to rectangular blocks
        with implicit zero padding of the matrix edges."""
        ro = np.asarray(csr.row_offsets)
        ci = np.asarray(csr.col_indices)
        va = np.asarray(csr.values)
        rows = csr.row_ids()

        brow = rows // block_rows
        bcol = ci // block_cols
        # Pass 1: unique (brow, bcol) pairs, sorted — these are the blocks.
        key = brow.astype(np.int64) * ((csr.num_cols // block_cols) + 1) + bcol
        order = np.argsort(key, kind="stable")
        sk = key[order]
        new_block = np.empty(sk.size, dtype=bool)
        if sk.size:
            new_block[0] = True
            new_block[1:] = sk[1:] != sk[:-1]
        block_id_sorted = np.cumsum(new_block) - 1 if sk.size else new_block
        num_blocks = int(block_id_sorted[-1]) + 1 if sk.size else 0

        blk_brow = brow[order][new_block] if sk.size else np.zeros(0, np.int32)
        blk_bcol = bcol[order][new_block] if sk.size else np.zeros(0, np.int32)

        # Pass 2: fill dense blocks.
        blocks = np.zeros((num_blocks, block_rows, block_cols), dtype=va.dtype)
        lr = (rows[order] % block_rows).astype(np.int64)
        lc = (ci[order] % block_cols).astype(np.int64)
        np.add.at(blocks, (block_id_sorted, lr, lc), va[order])

        nbr = -(-csr.num_rows // block_rows)
        counts = np.bincount(blk_brow, minlength=nbr)
        offs = np.zeros(nbr + 1, dtype=np.int32)
        np.cumsum(counts, out=offs[1:])
        return cls(
            csr.num_rows,
            csr.num_cols,
            block_rows,
            block_cols,
            offs,
            blk_bcol.astype(np.int32),
            blocks,
        )

    def to_csr(self):
        """Expand back to CSR, dropping explicit zeros introduced by
        block padding."""
        from sparsela.formats.coo import CooMatrix

        blocks = np.asarray(self.blocks)
        bro = np.asarray(self.block_row_offsets)
        bci = np.asarray(self.block_col_indices)
        blk_brow = np.repeat(
            np.arange(self.num_block_rows, dtype=np.int64), np.diff(bro)
        )
        bidx, lr, lc = np.nonzero(blocks)
        r = blk_brow[bidx] * self.block_rows + lr
        c = bci[bidx].astype(np.int64) * self.block_cols + lc
        keep = (r < self.num_rows) & (c < self.num_cols)
        coo = CooMatrix(
            self.num_rows,
            self.num_cols,
            r[keep].astype(np.int32),
            c[keep].astype(np.int32),
            blocks[bidx[keep], lr[keep], lc[keep]],
        )
        return coo.to_csr()

    def to_device(self, dtype=None) -> "BcsrMatrix":
        import jax.numpy as jnp

        blocks = np.asarray(self.blocks)
        if dtype is not None:
            blocks = blocks.astype(dtype)
        return BcsrMatrix(
            self.num_rows, self.num_cols, self.block_rows, self.block_cols,
            jnp.asarray(np.asarray(self.block_row_offsets), dtype=jnp.int32),
            jnp.asarray(np.asarray(self.block_col_indices), dtype=jnp.int32),
            jnp.asarray(blocks),
        )
