"""v1 data source declaration
(``paddle_tpu/trainer_config_helpers/data_sources.py``):
``define_py_data_sources2`` binds a PyDataProvider2 function to the
config's data layers."""

from __future__ import annotations

import importlib

from paddle_tpu_torch.trainer_config_helpers import layers as _layers

__all__ = ["define_py_data_sources2"]


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    """Record the provider binding in the active config capture.  The
    trainer resolves ``module.obj`` (decorated with @provider) and calls
    it for each file of train_list / test_list; the provider's declared
    input_types retype the config's data layers, now and again after the
    whole config has run (a config may declare its sources first)."""
    cap = _layers._g_capture
    if cap is None:
        raise RuntimeError("define_py_data_sources2 must run inside "
                           "parse_config (a v1 config file)")
    cap["data_sources"] = {
        "train_list": train_list,
        "test_list": test_list,
        "module": module,
        "obj": obj,
        "args": args or {},
    }
    try:
        mod = (module if not isinstance(module, str)
               else importlib.import_module(module))
        input_types = getattr(getattr(mod, obj), "input_types", None)
    except Exception:
        input_types = None
    if input_types:
        cap["_pending_input_types"] = input_types
        _apply_input_types(cap, input_types)


def _apply_input_types(cap, input_types):
    data_layers = cap.get("data_layers", {})
    if isinstance(input_types, dict):
        items = input_types.items()
    else:  # positional: the data layers' declaration order
        items = zip(list(data_layers), input_types)
    for name, t in items:
        lo = data_layers.get(name)
        if lo is not None:
            lo.input_type = t
            lo.is_seq = t.is_seq
