"""Hybrid DIA + remainder partition — dense diagonals on the shifted-FMA
path, scattered entries on a CSR plan.

``A = A_dia + A_rest`` elementwise, so ``y = A_dia x + A_rest x``
exactly (summing the two partial products is order-independent up to
fp rounding). ``ops.spmv.plan_matrix`` partitions at plan time and
dispatches on the :class:`HybridPlan` type.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax

from sparsela.ops.dia import spmm_dia, spmv_dia


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HybridPlan:
    """DIA part + any other device plan for the remainder (None when
    the diagonals cover the whole matrix — then this is pure DIA)."""

    dia: Any            # DiaDevice
    rest: Any           # CSR-family plan or None
    nnz: int            # real nonzeros (for flop accounting)

    def tree_flatten(self):
        return (self.dia, self.rest), (self.nnz,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def dtype(self):
        return self.dia.dtype


def spmv_hybrid(H: HybridPlan, x, alpha=1.0, beta=0.0, y=None):
    from sparsela.ops.spmv import spmv

    y_new = spmv_dia(H.dia, x)
    if H.rest is not None:
        y_new = spmv(H.rest, x, beta=1.0, y=y_new)
    if beta == 0.0 or y is None:
        return alpha * y_new if alpha != 1.0 else y_new
    return alpha * y_new + beta * y


def spmm_hybrid(H: HybridPlan, X, alpha=1.0, beta=0.0, Y=None):
    from sparsela.ops.spmv import spmm

    Y_new = spmm_dia(H.dia, X)
    if H.rest is not None:
        Y_new = spmm(H.rest, X, beta=1.0, Y=Y_new)
    if beta == 0.0 or Y is None:
        return alpha * Y_new if alpha != 1.0 else Y_new
    return alpha * Y_new + beta * Y
