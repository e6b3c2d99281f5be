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
from paddle_tpu_torch.executor import _to_numpy as _tensor_to_numpy
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


_TENSOR_MAGIC = b"PTPU"
_TENSOR_VERSION = 0


def serialize_tensor_bytes(arr) -> bytes:
    """The single-tensor file format of the ``save`` / ``load`` ops
    (``paddle_tpu/io.py:33-48``): magic, uint32 version, dtype name,
    dims, raw little-endian data.  ``arr`` is numpy or a tensor (a CUDA
    tensor is copied to the host first; bf16 goes by its ``ml_dtypes``
    name, as the JAX package writes it)."""
    import struct

    if isinstance(arr, torch.Tensor):
        arr = _tensor_to_numpy(arr)
    arr = np.ascontiguousarray(np.asarray(arr))
    dt = arr.dtype.name.encode()
    head = _TENSOR_MAGIC + struct.pack("<I", _TENSOR_VERSION)
    head += struct.pack("<H", len(dt)) + dt
    head += struct.pack("<I", arr.ndim) + struct.pack(
        f"<{arr.ndim}q", *arr.shape)
    return head + arr.tobytes()


def numpy_dtype(name: str) -> np.dtype:
    """numpy's dtype of a dtype name; bfloat16 is ``ml_dtypes``'."""
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def deserialize_tensor_bytes(buf: bytes) -> np.ndarray:
    """The array ``serialize_tensor_bytes`` wrote (either package's)."""
    import struct

    if buf[:4] != _TENSOR_MAGIC:
        raise ValueError("not a paddle_tpu tensor file")
    off = 4
    (version,) = struct.unpack_from("<I", buf, off)
    off += 4
    if version != _TENSOR_VERSION:
        raise ValueError(f"unsupported tensor format version {version}")
    (dtlen,) = struct.unpack_from("<H", buf, off)
    off += 2
    dtype = numpy_dtype(buf[off:off + dtlen].decode())
    off += dtlen
    (ndim,) = struct.unpack_from("<I", buf, off)
    off += 4
    dims = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    return np.frombuffer(buf, dtype=dtype, offset=off).reshape(dims).copy()


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


# ---------------------------------------------------------------------------
# Training checkpoints (``paddle_tpu/io.py:191-330``): every persistable
# (params and optimizer state) in orbax's PyTree layout, ``step_N``
# directories committed by a sibling ``step_N.complete`` marker.  The
# port writes the layout's plain form (one zarr v2 array a variable,
# uncompressed, ``use_ocdbt: false`` in ``_METADATA``), which orbax
# restores; it reads that form itself and the JAX package's OCDBT form
# through tensorstore, the storage library orbax reads it with.
# ---------------------------------------------------------------------------

_PYTREE_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                   "PyTreeCheckpointHandler")


def _step_dir(dirname, step) -> str:
    return os.path.join(os.path.abspath(dirname), f"step_{int(step)}")


def _marker_path(step_path: str) -> str:
    # a sibling file: every entry under the step dir belongs to the tree
    return step_path + ".complete"


def checkpoint_complete(dirname, step) -> bool:
    """True when step_N was fully written (its commit marker exists)."""
    return os.path.exists(_marker_path(_step_dir(dirname, step)))


def _write_tree(path: str, state) -> None:
    """{name: array} as an orbax PyTree directory at ``path``, written
    beside it and renamed into place."""
    import shutil
    import time

    tmp = path + ".orbax-checkpoint-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.time_ns()
    tree = {}
    for name, arr in state.items():
        arr = np.ascontiguousarray(_to_numpy(arr))
        os.makedirs(os.path.join(tmp, name))
        with open(os.path.join(tmp, name, ".zarray"), "w") as f:
            json.dump({"chunks": list(arr.shape), "compressor": None,
                       "dimension_separator": ".", "dtype": arr.dtype.str,
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(arr.shape), "zarr_format": 2}, f)
        if arr.size:
            chunk = ".".join("0" for _ in arr.shape) or "0"
            with open(os.path.join(tmp, name, chunk), "wb") as f:
                f.write(arr.tobytes())
        tree[repr((name,))] = {
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _PYTREE_HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)


def _read_zarr(path: str, name: str) -> np.ndarray:
    """One array of the plain form, as ``_write_tree`` writes it."""
    with open(os.path.join(path, name, ".zarray")) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    if (meta["compressor"] is not None or meta.get("filters")
            or tuple(meta["chunks"]) != shape or meta["order"] != "C"):
        raise ValueError(f"{path}: {name} is not one uncompressed C-order "
                         "zarr chunk")
    dtype = np.dtype(meta["dtype"])
    chunk = os.path.join(path, name, ".".join("0" for _ in shape) or "0")
    if not os.path.exists(chunk):   # an empty array
        return np.zeros(shape, dtype)
    with open(chunk, "rb") as f:
        return np.frombuffer(f.read(), dtype).reshape(shape).copy()


def _read_ocdbt(path: str, name: str) -> np.ndarray:
    """One array of the OCDBT form (the JAX package's) via tensorstore."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading an OCDBT orbax checkpoint (the JAX package's "
            "form) needs the tensorstore package") from e
    kv = {"driver": "ocdbt", "base": "file://" + os.path.abspath(path),
          "path": name + "/"}
    return np.asarray(ts.open({"driver": "zarr", "kvstore": kv}).result()
                      .read().result())


def _read_tree(path: str):
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    state = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if len(keys) != 1:
            raise ValueError(f"{path}: a nested checkpoint tree")
        name = keys[0]["key"]
        state[name] = (_read_ocdbt(path, name) if meta.get("use_ocdbt")
                       else _read_zarr(path, name))
    return state


def save_state_tree(dirname, step, state, max_to_keep=None):
    """Save {name: array} as step_N under ``dirname``, then commit it with
    a ``step_N.complete`` marker: readers (``latest_checkpoint_step``)
    see marked steps only.  ``max_to_keep`` prunes the oldest complete
    steps past the newest N.  Returns the step path."""
    path = _step_dir(dirname, step)
    _write_tree(path, state)
    with open(_marker_path(path), "w") as f:
        f.write(f"{int(step)}\n")
    if max_to_keep:
        prune_checkpoints(dirname, max_to_keep)
    return path


def load_state_tree(dirname, step):
    """The {name: numpy array} saved as step_N (by either package)."""
    return _read_tree(_step_dir(dirname, step))


def prune_checkpoints(dirname, max_to_keep):
    """Delete all but the newest ``max_to_keep`` complete step_N
    checkpoints, and unmarked ones older than the newest complete step
    (crash leftovers).  Returns the pruned step numbers."""
    import shutil

    if not os.path.isdir(dirname) or max_to_keep is None:
        return []
    complete, incomplete = [], []
    for d in os.listdir(dirname):
        if d.startswith("step_") and d[5:].isdigit():
            step = int(d[5:])
            (complete if checkpoint_complete(dirname, step)
             else incomplete).append(step)
    complete.sort()
    doomed = complete[:-int(max_to_keep)] if max_to_keep > 0 else []
    newest = complete[-1] if complete else None
    doomed += [s for s in incomplete if newest is not None and s < newest]
    for step in doomed:
        path = _step_dir(dirname, step)
        # the marker first: a half-deleted checkpoint reads as incomplete
        try:
            os.remove(_marker_path(path))
        except FileNotFoundError:
            pass
        shutil.rmtree(path, ignore_errors=True)
    return sorted(doomed)


def _collect_persistable_state(main_program, scope):
    state = {}
    for var in main_program.global_block().vars.values():
        if var.persistable:
            v = scope.get(var.name)
            if v is not None:
                state[var.name] = _to_numpy(v)
    return state


def save_checkpoint(dirname, executor=None, main_program=None, step=None,
                    scope=None, max_to_keep=None):
    """Save every persistable of ``main_program`` (params and optimizer
    state) from ``scope``: as ``dirname/step_N``, committed by its
    marker and pruned to ``max_to_keep``, when ``step`` is given, else
    as ``dirname`` itself.  Returns the path."""
    main_program = main_program or framework.default_main_program()
    scope = scope if scope is not None else global_scope()
    state = _collect_persistable_state(main_program, scope)
    if step is not None:
        return save_state_tree(dirname, step, state, max_to_keep=max_to_keep)
    path = os.path.abspath(dirname)
    _write_tree(path, state)
    return path


def load_checkpoint(dirname, executor=None, main_program=None, step=None,
                    scope=None):
    """Set the persistables saved by ``save_checkpoint`` (of either
    package) into ``scope``: on the executor's device, else where the
    scope holds the variable now, else the CPU; in the dtype
    ``main_program`` declares.  Returns the restored names, sorted."""
    main_program = main_program or framework.default_main_program()
    scope = scope if scope is not None else global_scope()
    path = _step_dir(dirname, step) if step is not None else \
        os.path.abspath(dirname)
    block = main_program.global_block()
    state = _read_tree(path)
    for name, arr in state.items():
        var = block.vars.get(name)
        if var is not None and var.dtype not in (None, "bfloat16"):
            arr = np.asarray(arr).astype(var.dtype, copy=False)
        old = scope.get(name)
        device = (executor.device if executor is not None else
                  old.device if isinstance(old, torch.Tensor) else
                  torch.device("cpu"))
        scope.load_numpy({name: arr}, device)
    return sorted(state)


def latest_checkpoint_step(dirname):
    """The highest complete step_N under ``dirname``, or None.  A step
    without its ``step_N.complete`` marker is a write in progress or a
    torn one, and is never returned."""
    if not os.path.isdir(dirname):
        return None
    steps = [int(d[5:]) for d in os.listdir(dirname)
             if d.startswith("step_") and d[5:].isdigit()
             and checkpoint_complete(dirname, int(d[5:]))]
    return max(steps) if steps else None
