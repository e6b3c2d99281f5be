"""Profiling (``paddle_tpu/profiler.py``; reference:
python/paddle/v2/fluid/profiler.py, which wraps nvprof).  The port's
trace is ``torch.profiler``'s: CPU and CUDA activities on the card, CPU
only on a CPU run, written as a Chrome trace."""

from __future__ import annotations

import contextlib
import inspect
import os
import tempfile

import torch

from paddle_tpu_torch import framework

TRACE_FILE = "trace.json"


def _profile_options():
    """Keyword names ``torch.profiler.profile`` accepts beyond the
    activities, which the place decides (introspected, so this tracks
    the installed torch)."""
    params = inspect.signature(torch.profiler.profile).parameters
    return frozenset(list(params)[1:])


@contextlib.contextmanager
def profiler(output_dir: str = None, place=None, **kwargs):
    """Trace the block under ``torch.profiler.profile`` and write
    ``output_dir/trace.json`` (Chrome trace; ``chrome://tracing`` or
    Perfetto).  ``place`` is ``CUDAPlace(0)`` unless the caller passes
    ``CPUPlace()``.  Keyword options go to ``torch.profiler.profile``
    (e.g. ``record_shapes=True``); an unknown name raises before the
    trace starts.  Yields the profile object."""
    supported = _profile_options()
    unknown = sorted(set(kwargs) - supported)
    if unknown:
        raise TypeError(
            f"profiler(): unsupported option(s) {unknown}; "
            f"torch.profiler.profile accepts {sorted(supported)}")
    place = framework.resolve_place(place)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if isinstance(place, framework.CUDAPlace):
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    output_dir = output_dir or os.path.join(tempfile.gettempdir(),
                                            "paddle_tpu_torch_profile")
    os.makedirs(output_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities, **kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(output_dir, TRACE_FILE))


# reference-compatible alias (fluid.profiler.cuda_profiler)
cuda_profiler = profiler


def annotate(name: str):
    """A named range in the trace: ``torch.profiler.record_function``."""
    return torch.profiler.record_function(name)
