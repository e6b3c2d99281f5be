"""Process-level flag registry (``paddle_tpu/flags.py``; reference: the
gflags tier, paddle/utils/Flags.cpp:18-39, which declares flags such as
use_gpu, trainer_count, log_period and seed, initialised from Python by
init_gflags, pybind/pybind.cc:441).

The definitions and defaults are the JAX package's.  Two flags act on
the port's ``Executor``: ``trace_ops`` wraps each op's run in
``torch.profiler.record_function(op.type)``, keys the plan cache and
keeps a plan off its CUDA graph, and ``check_program`` runs the static
verifier's error tier (``analysis/``) at every plan-cache miss."""

from __future__ import annotations

import os
from typing import Any, Dict


class _Flags:
    def __init__(self):
        self._defs: Dict[str, tuple] = {}   # name -> (default, type, help)
        self._vals: Dict[str, Any] = {}

    def define(self, name: str, default, help: str = ""):
        self._defs[name] = (default, type(default), help)

    def set(self, name: str, value):
        if name in self._defs:
            _, t, _ = self._defs[name]
            if t is bool and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes")
            else:
                value = t(value)
        self._vals[name] = value

    def get(self, name: str, default=None):
        if name in self._vals:
            return self._vals[name]
        if name in self._defs:
            return self._defs[name][0]
        return default

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


FLAGS = _Flags()

# the reference's commonly used flags (utils/Flags.cpp), same defaults
FLAGS.define("use_gpu", False, "train on the card (v2.init records it)")
FLAGS.define("trainer_count", 1, "data-parallel replica count")
FLAGS.define("seed", 1, "RNG seed (0 = nondeterministic)")
FLAGS.define("log_period", 100, "batches between log lines")
FLAGS.define("show_layer_stat", False, "dump per-layer timing each pass")
FLAGS.define("save_dir", "", "checkpoint directory")
FLAGS.define("num_passes", 1, "training passes")
FLAGS.define("parallel_nn", False, "model-parallel layer placement")
FLAGS.define("port", 20134, "pserver base port")
FLAGS.define("num_gradient_servers", 1, "sync-SGD barrier width")
# run the static verifier's error tier over a program at every plan-cache
# miss (analysis.check_or_raise).  PADDLE_CHECK_PROGRAM seeds the default.
FLAGS.define("check_program",
             os.environ.get("PADDLE_CHECK_PROGRAM", "").lower()
             in ("1", "true", "yes"),
             "verify programs before running them (error-tier analysis)")
# per-op trace ranges: with trace_ops=1 the Executor runs each op inside
# torch.profiler.record_function(op.type), so a profiler trace names
# the ops.  Part of the plan-cache key; seeded from PADDLE_TRACE_OPS so
# profiling runs need no code change.
FLAGS.define("trace_ops",
             os.environ.get("PADDLE_TRACE_OPS", "").lower()
             in ("1", "true", "yes"),
             "name each op in profiler traces (record_function)")


def init_gflags(argv):
    """Parse --k=v strings (reference: init_gflags, pybind.cc:441);
    returns the arguments that are not flags."""
    rest = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            FLAGS.set(k, v)
        else:
            rest.append(a)
    return rest


def init_from_env(prefix: str = "PADDLE_"):
    for k, v in os.environ.items():
        if k.startswith(prefix):
            FLAGS.set(k[len(prefix):].lower(), v)
