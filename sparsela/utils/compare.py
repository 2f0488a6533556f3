"""Result-comparison utilities.

Capability parity with the reference's ``CompareResults`` family
(``utils.h:664-864``): a ULP-style comparator that
reinterprets float bits as integers and fails when
``sqrt(|int_a - int_b|) > len`` — i.e. tolerance loosens with vector
length. The reference demotes fp64 results to fp32 before comparing
(utils.h:717-721), which this reproduces; exact comparison for integer
types.
"""

from __future__ import annotations

import numpy as np


def ulp_distance(a, b) -> np.ndarray:
    """Per-element distance in units-in-the-last-place (fp32 lattice)."""
    a32 = np.asarray(a, dtype=np.float32)
    b32 = np.asarray(b, dtype=np.float32)
    ia = a32.view(np.int32).astype(np.int64)
    ib = b32.view(np.int32).astype(np.int64)
    # map the signed-magnitude float lattice onto a monotone integer line
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def compare_results(computed, reference) -> tuple[bool, int]:
    """Reference-semantics comparison: PASS when
    sqrt(max ULP distance) <= len (utils.h:684-733; fp64 demoted to
    fp32 first). Returns (ok, index of worst element)."""
    computed = np.asarray(computed)
    reference = np.asarray(reference)
    if computed.dtype.kind in "iu":
        diff = computed != reference
        if diff.any():
            return False, int(np.argmax(diff))
        return True, 0
    d = ulp_distance(computed, reference)
    worst = int(np.argmax(d))
    ok = bool(np.sqrt(float(d.max())) <= computed.size)
    return ok, worst


def assert_close(computed, reference, context: str = "") -> None:
    ok, worst = compare_results(computed, reference)
    if not ok:
        c = np.asarray(computed).ravel()[worst]
        r = np.asarray(reference).ravel()[worst]
        raise AssertionError(
            f"FAIL {context}: element {worst}: computed {c!r} vs "
            f"reference {r!r}"
        )
