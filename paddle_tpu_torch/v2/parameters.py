"""Parameters: the trained weights in a Scope, read and written as numpy
by name, and saved and loaded as a tar of one ``<name>.npy`` member a
parameter (``paddle_tpu/v2/parameters.py``): a tar written by either
package loads in the other."""

from __future__ import annotations

import io as _io
import tarfile
from typing import Optional

import numpy as np

from paddle_tpu_torch import executor as executor_mod
from paddle_tpu_torch.executor import Executor, tensor_from_numpy
from paddle_tpu_torch.framework import Place
from paddle_tpu_torch.v2.topology import Topology


def write_npy_tar(named_arrays, f):
    """Write (name, array) pairs in the Parameters tar layout: one
    ``<name>.npy`` member a parameter."""
    with tarfile.open(fileobj=f, mode="w") as tar:
        for name, arr in named_arrays:
            buf = _io.BytesIO()
            np.save(buf, np.ascontiguousarray(np.asarray(arr)),
                    allow_pickle=False)
            data = buf.getvalue()
            info = tarfile.TarInfo(name=name + ".npy")
            info.size = len(data)
            tar.addfile(info, _io.BytesIO(data))


def create(cost_or_topology, place: Optional[Place] = None) -> "Parameters":
    """``paddle.parameters.create``: Parameters of a cost layer's
    Topology (built once and kept on the layer, so the trainer reuses
    it) or of a given Topology, on ``place`` (``CUDAPlace(0)`` unless
    the caller passes another)."""
    if isinstance(cost_or_topology, Topology):
        topo = cost_or_topology
    else:
        lo = cost_or_topology
        if lo._topology is None:
            lo._topology = Topology(lo)
        topo = lo._topology
    return Parameters(topo, place)


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

    # -- serialization --------------------------------------------------------

    def to_tar(self, f):
        write_npy_tar(((name, self.get(name)) for name in self._names), f)

    @classmethod
    def from_tar(cls, f, topology: Optional[Topology] = None,
                 place: Optional[Place] = None) -> "Parameters":
        """New Parameters of ``topology`` (initialised by its startup
        program on ``place``), then every member of the tar set."""
        if topology is None:
            raise ValueError("from_tar needs the Topology the tar was "
                             "written from")
        p = cls(topology, place)
        p.load_tar(f)
        return p

    def load_tar(self, f):
        """Set every ``<name>.npy`` member of the tar (a file object) on
        this scope's device."""
        arrays = {}
        with tarfile.open(fileobj=f, mode="r") as tar:
            for m in tar.getmembers():
                name = m.name[:-4] if m.name.endswith(".npy") else m.name
                arrays[name] = np.load(_io.BytesIO(tar.extractfile(m).read()),
                                       allow_pickle=False)
        self.scope.load_numpy(arrays, self.place.device())

    init_from_tar = load_tar
