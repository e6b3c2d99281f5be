"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100.

The same fluid-style surface as ``paddle_tpu`` for serving and training:
``layers`` build a Program, ``optimizer.*.minimize`` appends the
backward (``append_backward``) and the update ops, the op registry
interprets it on torch tensors, and the ``Executor`` runs it on
``CUDAPlace(0)`` unless the caller passes ``CPUPlace()``.  The hot ops
run hand-written CUDA kernels (``paddle_tpu_torch/csrc``, wrappers in
``kernels/``); on CPU tensors the wrappers run the kernels' plain
PyTorch versions.  The port never
imports jax or paddle_tpu; it reads their Program dict and export
formats unchanged.
"""

from paddle_tpu_torch import ops  # noqa: F401  (registers the op lowerings)
from paddle_tpu_torch import (amp, clip, evaluator, framework, initializer,
                              io, layers, lr_scheduler, models, nets,
                              optimizer, param_attr, regularizer)
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.executor import (Executor, Scope, global_scope,
                                       params_from_numpy, scope_guard)
from paddle_tpu_torch.framework import (CPUPlace, CUDAPlace, Program,
                                        default_main_program,
                                        default_startup_program,
                                        program_guard)
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "CPUPlace", "CUDAPlace", "Executor", "ParamAttr", "Program", "Scope",
    "amp", "append_backward", "clip", "default_main_program",
    "default_startup_program", "evaluator", "framework", "global_scope",
    "initializer", "io", "layers", "lr_scheduler", "models", "nets",
    "optimizer", "param_attr",
    "params_from_numpy", "program_guard", "regularizer", "scope_guard",
]
