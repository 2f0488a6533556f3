"""Device timing — host clock around work that ends in
``block_until_ready``.

Parity with the reference methodology (``utils.h:531-654``,
``cpu_spmv.cpp:330-347``, ``no_pretreatment.hpp:232-255``): warmup
pass(es), then timed repetitions; the result keeps every sample so a
caller can report the median and the spread.

JAX dispatch is asynchronous: a timing that does not end in
``block_until_ready`` measures the enqueue, not the work. Each sample
here is one call of an already-compiled function, so one dispatch's
host overhead and synchronisation is inside it (about 0.2 ms on one
H100's host, PERF.md) — sizes that finish in less than that measure
the launch, not the kernel; ``bench.trace`` gives the device time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Timing:
    """Seconds per call, one sample per timed repetition."""

    samples_s: list[float] = field(default_factory=list)

    @property
    def median_s(self) -> float:
        return float(np.median(self.samples_s))

    @property
    def min_s(self) -> float:
        return float(np.min(self.samples_s))

    @property
    def iqr_s(self) -> float:
        """Distance between the quartiles — the run-to-run spread."""
        q1, q3 = np.percentile(self.samples_s, [25, 75])
        return float(q3 - q1)


def time_fn(fn, *args, reps: int = 20, warmup: int = 2) -> Timing:
    """Time ``fn(*args)`` (compiled on the warmup calls) ``reps``
    times, each sample ending when the result is ready on the device."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return Timing(samples)


def copy_rate_gbs(nbytes: int = 1 << 30, reps: int = 20) -> float:
    """Bytes/s (GB/s) of a large elementwise copy (read + write of
    ``nbytes`` f32) measured in this process — the practical bandwidth
    ceiling every roofline share is also given against."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((nbytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    t = time_fn(f, x, reps=reps)
    return 2 * nbytes / t.median_s / 1e9
