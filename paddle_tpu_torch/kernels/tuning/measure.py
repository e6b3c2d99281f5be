"""Device time of one tuning candidate (``paddle_tpu/pallas/tuning/
measure.py``).

A candidate runs through the public wrapper with a one-entry database in
place (``pinned``), so the launch is the one dispatch makes for that
entry.  Its first output is held against the kernel's plain version
(``space.Case``); then CUDA events time ``CHAIN`` back-to-back calls, and
the reported figure is the median over ``reps`` such samples, a call's
share, after warm-up.  A candidate that fails to launch or leaves the
kernel's tolerance raises ``Infeasible``, which the tuner records and
never lets out.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Any, Dict, Optional, Tuple

from paddle_tpu_torch.kernels import tuning
from paddle_tpu_torch.kernels.tuning import space as _space
from paddle_tpu_torch.kernels.tuning.db import TuningDB, make_key

#: Calls a timed sample holds (a short kernel's launch gaps amortize).
CHAIN = 4


class Infeasible(Exception):
    """The candidate failed to launch, or its output left the kernel's
    tolerance against its plain version."""


@contextlib.contextmanager
def pinned(family: str, shape, dtype: str, cfg: Optional[Dict[str, Any]],
           device_kind: str):
    """A one-entry database with ``cfg`` at (family, shape, dtype) in
    place for the block (None: an empty one, every wrapper's default);
    the database in place before comes back after it."""
    saved = tuning._STATE["db"]
    if cfg is None:
        tuning.disable()
    else:
        tuning.set_db(TuningDB({make_key(family, shape, dtype, device_kind):
                                {"config": dict(cfg)}}))
    try:
        yield
    finally:
        tuning.set_db(None if saved is tuning._UNSET else saved)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds a call of ``fn`` over ``reps`` samples of
    CHAIN calls each, timed by CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CHAIN):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / CHAIN)
    return statistics.median(samples)


def measure_config(family: "_space.Family", case: "_space.Case", shape,
                   dtype: str, cfg: Optional[Dict[str, Any]],
                   device_kind: str, reps: int = 5) -> Tuple[float, float]:
    """(ms, max abs error) of one (shape, config) point; ``cfg=None`` is
    the wrapper's own choice.  Raises ``Infeasible`` on a failed launch or
    an output past the case's tolerance."""
    import torch

    try:
        with pinned(family.name, shape, dtype, cfg, device_kind):
            out = case.run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            err, limit = case.error(out)
            if not err <= limit:
                raise Infeasible(
                    f"{family.name}{tuple(shape)} {cfg}: max abs error "
                    f"{err:.3e} past the tolerance {limit:.3e}")
            return time_ms(case.run, reps=reps), err
    except Infeasible:
        raise
    except KeyboardInterrupt:
        raise
    except Exception as e:   # a refused launch, an illegal address...
        raise Infeasible(f"{family.name}{tuple(shape)} {cfg}: "
                         f"{type(e).__name__}: {e}") from e
