"""Random number utilities.

Capability parity with the reference's RNG (``utils.h``):
``mersenne::genrand_int32`` (:76) is the MT19937 generator — exposed
here through numpy's bit generator of the same algorithm — and
``RandomBits`` (:214) reduces entropy by AND-ing together several draws
(biasing bits toward 0) to produce clustered key distributions for
benchmark inputs."""

from __future__ import annotations

import numpy as np


def mersenne(seed: int = 0) -> np.random.Generator:
    """MT19937-backed generator (the reference's mersenne::init_genrand)."""
    return np.random.Generator(np.random.MT19937(seed))


def random_bits(gen: np.random.Generator, shape, entropy_reduction: int = 0,
                dtype=np.uint32) -> np.ndarray:
    """Entropy-reduced random bits (parity: RandomBits, utils.h:214):
    AND together ``entropy_reduction + 1`` independent draws, biasing
    bits low; entropy_reduction < 0 yields all-ones."""
    if entropy_reduction < 0:
        return np.full(shape, np.iinfo(dtype).max, dtype=dtype)
    out = gen.integers(0, np.iinfo(dtype).max, size=shape,
                       dtype=dtype, endpoint=True)
    for _ in range(entropy_reduction):
        out &= gen.integers(0, np.iinfo(dtype).max, size=shape,
                            dtype=dtype, endpoint=True)
    return out


def random_values(gen: np.random.Generator, shape, dtype=np.float64
                  ) -> np.ndarray:
    """Uniform values in [0, 1) (parity: RandomValue fill loops)."""
    return gen.random(size=shape, dtype=np.float64).astype(dtype)
