"""``paddle.v2.fluid`` (``paddle_tpu/v2/fluid/``): the fluid API is the
port's root package, and this alias makes the v2 spellings run as they
are (``import paddle_tpu_torch.v2.fluid as fluid``, ``from
paddle_tpu_torch.v2.fluid import layers``, ``import
paddle_tpu_torch.v2.fluid.layers``)."""

import importlib
import sys

import paddle_tpu_torch as _root

_SUBMODULES = [
    "layers", "nets", "optimizer", "regularizer", "initializer",
    "framework", "executor", "backward", "io", "evaluator", "profiler",
    "param_attr", "net_drawer", "data_feeder", "registry",
    "default_scope_funcs", "layer_helper", "clip",
]

for _m in _SUBMODULES:
    _mod = importlib.import_module(f"paddle_tpu_torch.{_m}")
    globals()[_m] = _mod
    sys.modules[__name__ + "." + _m] = _mod
del _m, _mod


def __getattr__(name):
    # Program, Executor, CPUPlace, CUDAPlace, program_guard, ... from the
    # root package
    return getattr(_root, name)
