"""Shape bucketing shared by the kernel tuner and the serving bucketer
(``paddle_tpu/pallas/tuning/bucket.py``).

One tuned config should cover a *bucket* of shapes, not a single point,
for the same reason the serving engine coalesces requests into
power-of-two batch buckets (serving/batching.py): a replica wants a
small closed set of run plans (and CUDA graphs), and a tuning database
wants a small closed set of keys.  Both layers round through THIS
module so their ladders can never drift apart.

Pure Python, no torch or numpy imports: serving imports this at module
load.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def bucket_dim(n: int) -> int:
    """Smallest power-of-two >= n (n <= 1 maps to 1).

    This is the serving engine's ``next_bucket`` ladder: 1, 2, 4, 8...
    """
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Round every dimension up the power-of-two ladder."""
    return tuple(bucket_dim(int(d)) for d in shape)


def bucket_ladder(max_value: int) -> Tuple[int, ...]:
    """All buckets up to (and including) the one covering max_value:
    1, 2, 4, ..., bucket_dim(max_value)."""
    out = []
    b = 1
    while b < max_value:
        out.append(b)
        b <<= 1
    out.append(bucket_dim(max_value))
    return tuple(out)
