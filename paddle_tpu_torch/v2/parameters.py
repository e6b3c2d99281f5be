"""Parameters: the trained weights in a Scope, read and written as numpy
by name (``paddle_tpu/v2/parameters.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from paddle_tpu_torch import executor as executor_mod
from paddle_tpu_torch.executor import Executor, tensor_from_numpy
from paddle_tpu_torch.framework import Place
from paddle_tpu_torch.v2.topology import Topology


class Parameters:
    """The topology's startup program run into a Scope of its own on
    ``place`` (``CUDAPlace(0)`` unless the caller passes another)."""

    def __init__(self, topology: Topology, place: Optional[Place] = None):
        self.topology = topology
        self.scope = executor_mod.Scope()
        exe = Executor(place)
        self.place = exe.place
        exe.run(topology.startup_program, scope=self.scope)
        self._names = [p.name for p in topology.main_program.all_parameters()]

    def keys(self):
        return list(self._names)

    names = keys

    def has_key(self, key):
        return key in self._names

    def __iter__(self):
        return iter(self._names)

    def get(self, name) -> np.ndarray:
        v = self.scope.get(name)
        if v is None:
            raise KeyError(name)
        return executor_mod._to_numpy(v)

    __getitem__ = get

    def set(self, name, value):
        """``value`` (numpy or a tensor) on this scope's device, its dtype
        kept."""
        device = self.place.device()
        self.scope.set(name, tensor_from_numpy(value, device)
                       if not hasattr(value, "to") else value.to(device))

    __setitem__ = set

    def get_shape(self, name):
        return tuple(self.get(name).shape)
