"""The v1 config parser (``paddle_tpu/trainer/config_parser.py``): the
DSL constructors already build the lazy LayerOutput DAG, so parsing runs
the config under a capture and packages what it declared, with
proto-shaped views (``model_config.layers``) and the live LayerOutputs
the trainer builds into a Program.  A config that declares a data
source (``define_py_data_sources2``) has its data layers retyped from
the provider's input types once the whole config has run."""

from __future__ import annotations

import os
from typing import Optional

from paddle_tpu_torch.trainer_config_helpers import layers as _layers


class ModelConfigView:
    """A proto-shaped summary of the captured layers."""

    def __init__(self, cap: dict):
        self.layers = cap.get("layers", [])
        self.input_layer_names = cap.get("input_layer_names", [])
        self.output_layer_names = [lo.name for lo in cap.get("outputs", [])]

    def layer(self, name: str) -> Optional[dict]:
        return next((l for l in self.layers if l["name"] == name), None)


class TrainerConfig:
    """parse_config's result: the captured DSL state and the live
    LayerOutputs."""

    def __init__(self, cap: dict):
        self._cap = cap
        self.model_config = ModelConfigView(cap)
        self.opt_config = cap.get("settings", {})
        self.outputs = cap.get("outputs", [])
        self.evaluators = cap.get("evaluators", [])
        self.data_sources = cap.get("data_sources")
        self.data_layers = cap.get("data_layers", {})

    @property
    def cost(self):
        return self.outputs[0] if self.outputs else None


def _parse_config_args(config_arg_str: str) -> dict:
    args = {}
    for kv in (config_arg_str or "").split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            args[k.strip()] = v.strip()
    return args


def parse_config(config, config_arg_str: str = "") -> TrainerConfig:
    """Run a v1 config (a path to a Python file, or a callable) and return
    the captured TrainerConfig; ``config_arg_str`` ("k=v,...") feeds the
    file's ``get_config_arg``."""
    cap: dict = {}
    args = _parse_config_args(config_arg_str)

    def get_config_arg(name, type_=str, default=None):
        if name in args:
            if type_ is bool:
                return str(args[name]).lower() in ("1", "true", "yes")
            return type_(args[name])
        return default

    _layers._begin_capture(cap)
    try:
        if callable(config):
            config()
        else:
            path = os.fspath(config)
            with open(path) as f:
                src = f.read()
            glb = {"__file__": path, "__name__": "__paddle_tpu_config__",
                   "get_config_arg": get_config_arg}
            exec(compile(src, path, "exec"), glb)
    finally:
        _layers._end_capture()
    pending = cap.get("_pending_input_types")
    if pending:
        from paddle_tpu_torch.trainer_config_helpers.data_sources import \
            _apply_input_types

        _apply_input_types(cap, pending)
    return TrainerConfig(cap)
