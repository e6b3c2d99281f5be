"""Model persistence, in the JAX package's export layout
(``paddle_tpu/io.py:68-172``): a directory of one ``<var>.npy`` per
variable plus ``MANIFEST.json``, and for an inference export the pruned
program as ``__model__.json``.  An export or a checkpoint
(``save_persistables``) written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.executor import Scope, global_scope
from paddle_tpu_torch.framework import Parameter, Program, Variable

_FORMAT_VERSION = 1


def _is_persistable(var: Variable) -> bool:
    return var.persistable


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16; cast before saving")
        return value.numpy()
    return np.asarray(value)


def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              predicate=_is_persistable, vars=None, scope: Scope = None):
    main_program = main_program or framework.default_main_program()
    os.makedirs(dirname, exist_ok=True)
    scope = scope if scope is not None else global_scope()
    if vars is None:
        vars = [v for v in main_program.global_block().vars.values()
                if predicate(v)]
    manifest = {"format_version": _FORMAT_VERSION, "vars": {}}
    for v in vars:
        val = scope.get(v.name)
        if val is None:
            continue
        arr = _to_numpy(val)
        np.save(os.path.join(dirname, v.name + ".npy"), arr, allow_pickle=False)
        manifest["vars"][v.name] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(dirname, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_vars(executor, dirname: str, main_program: Optional[Program] = None,
              predicate=_is_persistable, vars=None, scope: Scope = None):
    """Set each selected variable of ``main_program`` from its
    ``<name>.npy`` in ``dirname``, as a tensor on the executor's device.
    Raises when one has no saved value."""
    main_program = main_program or framework.default_main_program()
    scope = scope if scope is not None else global_scope()
    if vars is None:
        vars = [v for v in main_program.global_block().vars.values()
                if predicate(v)]
    arrays = {}
    for v in vars:
        path = os.path.join(dirname, v.name + ".npy")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no saved value for variable {v.name!r} in {dirname}")
        arrays[v.name] = np.load(path)
    scope.load_numpy(arrays, executor.device)


def save_params(executor, dirname, main_program=None, scope: Scope = None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              scope=scope)


def load_params(executor, dirname, main_program=None, scope: Scope = None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              scope=scope)


def save_persistables(executor, dirname, main_program=None,
                      scope: Scope = None):
    """Every persistable: parameters, BN running statistics, the learning
    rate and the optimizer's accumulators (a training checkpoint)."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              scope=scope)


def load_persistables(executor, dirname, main_program=None,
                      scope: Scope = None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              scope=scope)


def get_inference_program(target_vars,
                          main_program: Optional[Program] = None) -> Program:
    """Flip the program to inference mode (``clone(for_test=True)``) and
    prune it to the targets."""
    main_program = main_program or framework.default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return main_program.clone(for_test=True).prune(list(target_vars))


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor,
                         main_program: Optional[Program] = None,
                         scope: Scope = None):
    """Prune to the inference slice and save program + params."""
    main_program = main_program or framework.default_main_program()
    os.makedirs(dirname, exist_ok=True)
    inference_program = get_inference_program(list(target_vars), main_program)
    with open(os.path.join(dirname, "__model__.json"), "w") as f:
        json.dump({
            "program": inference_program.to_dict(),
            "feed_names": list(feeded_var_names),
            "fetch_names": [v.name if isinstance(v, Variable) else v
                            for v in target_vars],
        }, f, default=str)
    save_params(executor, dirname, main_program, scope=scope)
    return inference_program


def read_inference_export(dirname: str):
    """Parse a ``save_inference_model`` directory without touching any
    scope: ``(program, feed_names, fetch_names, param_names)``."""
    with open(os.path.join(dirname, "__model__.json")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    manifest_path = os.path.join(dirname, "MANIFEST.json")
    param_names = []
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            param_names = list(json.load(f)["vars"])
    return program, meta["feed_names"], meta["fetch_names"], param_names


def load_exported_param(dirname: str, name: str) -> np.ndarray:
    """One parameter from a ``save_inference_model`` export."""
    return np.load(os.path.join(dirname, name + ".npy"))


def load_inference_model(dirname: str, executor, scope: Scope = None):
    """Read the export and set its parameters into ``scope`` as tensors
    on the executor's device."""
    program, feed_names, fetch_names, param_names = \
        read_inference_export(dirname)
    scope = scope if scope is not None else global_scope()
    scope.load_numpy(
        {name: load_exported_param(dirname, name) for name in param_names},
        executor.device)
    return program, feed_names, fetch_names
