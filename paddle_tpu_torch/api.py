"""The SWIG api surface (``paddle_tpu/api.py``; the reference's
``paddle/api/PaddleAPI.h:103-546``): ``initPaddle``, ``Arguments``,
``GradientMachine``, ``Matrix`` / ``Vector`` / ``IVector``,
``Parameter``, ``ParameterConfig``, ``OptimizationConfig``,
``ParameterOptimizer`` and ``SequenceGenerator``.

The buffer types stay host-side numpy, so an in-place view writes
through, as the reference's converters had it.  ``GradientMachine``
runs its Topology on ``place`` (``CUDAPlace(0)`` unless the caller
passes another, as ``v2.parameters.Parameters`` does; never from
``FLAGS.use_gpu``).  ``ParameterOptimizer`` applies the rules of the
reference's native optimizer (``paddle_tpu/native/src/optimizer.cc``:
``sgd`` with momentum and nesterov, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``adam``, ``adamax``, with ``decay`` and the
``const`` / ``linear`` learning-rate policy) as PyTorch on its place,
with the C++ casts: the hyperparameters, the learning rate and the bias
corrections are doubles cast to float, and the updates are float.
``SequenceGenerator`` decodes a v1 ``beam_search`` spec through
``generation.SequenceGenerator``, on ``place`` (``CUDAPlace(0)`` unless
the caller passes another).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


def initPaddle(*args):
    """``swig_paddle.initPaddle('--use_gpu=false', ...)``: the flag
    strings are recorded in ``FLAGS`` and nothing more; the place is each
    entry point's ``place`` argument."""
    from paddle_tpu_torch import flags as _flags

    for a in args:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            _flags.FLAGS.set(k, v)


class Arguments:
    """Positional in/out slots (reference: api/PaddleAPI.h Arguments +
    paddle/parameter/Argument.h).  Values are numpy arrays; sequence
    slots carry (value, lengths)."""

    def __init__(self, n: int):
        self._vals: List[Optional[np.ndarray]] = [None] * n
        self._lens: List[Optional[np.ndarray]] = [None] * n

    @staticmethod
    def createArguments(n: int) -> "Arguments":
        return Arguments(n)

    def getSlotNum(self) -> int:
        return len(self._vals)

    def resize(self, n: int):
        self._vals = (self._vals + [None] * n)[:n]
        self._lens = (self._lens + [None] * n)[:n]

    def setSlotValue(self, i: int, value):
        self._vals[i] = np.asarray(value)

    def getSlotValue(self, i: int):
        return self._vals[i]

    def setSlotIds(self, i: int, ids):
        self._vals[i] = np.asarray(ids, np.int64)

    def getSlotIds(self, i: int):
        return self._vals[i]

    def setSlotSequenceStartPositions(self, i: int, lens):
        self._lens[i] = np.asarray(lens, np.int32)

    def getSlotSequenceStartPositions(self, i: int):
        return self._lens[i]


class GradientMachine:
    """Forward and backward over a v2 Topology (the reference's
    ``api/GradientMachine.cpp``) on ``place``: ``CUDAPlace(0)`` unless
    the caller passes another.  ``forward`` runs the test clone;
    ``forwardBackward`` fetches the cost and every parameter's gradient
    (into ``_last_grads``)."""

    def __init__(self, cost_or_outputs, parameters=None, is_test=False,
                 place=None):
        from paddle_tpu_torch import backward as backward_mod
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.v2 import parameters as v2p
        from paddle_tpu_torch.v2.topology import Topology

        outs = (cost_or_outputs if isinstance(cost_or_outputs, (list, tuple))
                else [cost_or_outputs])
        self._output_layers = list(outs)
        if place is None and parameters is not None:
            place = parameters.place
        self._exe = Executor(place)
        if is_test:
            self.topology = Topology(cost=None,
                                     output_layers=self._output_layers,
                                     is_test=True)
            self.parameters = parameters
        else:
            self.topology = Topology(outs[0])
            self.parameters = parameters or v2p.Parameters(
                self.topology, self._exe.place)
        self._grad_names = None
        if not is_test:
            with framework.program_guard(self.topology.main_program,
                                         self.topology.startup_program):
                pgs = backward_mod.append_backward(self.topology.cost_var)
            self._grad_names = [(p.name, g.name) for p, g in pgs]
        self._init()

    @staticmethod
    def createFromConfigProto(conf, *args, place=None, **kwargs
                              ) -> "GradientMachine":
        """A parsed v1 TrainerConfig (``trainer.config_parser``) or a cost
        LayerOutput."""
        cost = getattr(conf, "cost", conf)
        return GradientMachine(cost, place=place)

    def _init(self):
        if self.parameters is not None:
            self._exe.run(self.topology.startup_program,
                          scope=self.parameters.scope)

    def _feed_from_args(self, in_args: Arguments):
        feed = {}
        for i, (name, t) in enumerate(self.topology.feed_types):
            v = in_args.getSlotValue(i)
            if v is None:
                raise ValueError(f"slot {i} ({name}) not set")
            feed[name] = v
            lens = in_args.getSlotSequenceStartPositions(i)
            if lens is not None:
                feed[name + "@len"] = lens
        return feed

    def forward(self, in_args: Arguments, out_args: Arguments, pass_type=None):
        prog = self.topology.main_program.clone(for_test=True)
        outs = self._exe.run(prog, feed=self._feed_from_args(in_args),
                             fetch_list=self.topology.output_vars,
                             scope=self.parameters.scope)
        out_args.resize(len(outs))
        for i, o in enumerate(outs):
            out_args.setSlotValue(i, np.asarray(o))
        return outs

    def forwardBackward(self, in_args: Arguments, out_args: Arguments,
                        pass_type=None):
        """One forward and backward; the cost in ``out_args`` slot 0, the
        gradients in ``_last_grads`` (parameter name -> numpy)."""
        assert self._grad_names is not None, "test-mode machine"
        fetch = [self.topology.cost_var] + [g for _, g in self._grad_names]
        outs = self._exe.run(self.topology.main_program,
                             feed=self._feed_from_args(in_args),
                             fetch_list=fetch, scope=self.parameters.scope)
        out_args.resize(1)
        out_args.setSlotValue(0, np.asarray(outs[0]))
        self._last_grads = {p: np.asarray(g)
                            for (p, _), g in zip(self._grad_names, outs[1:])}
        return outs[0]

    def getParameters(self):
        return self.parameters

    def getParameterSize(self):
        """The reference's ``GradientMachine::getParameterSize``."""
        return len(self.parameters.keys())

    def getParameter(self, i):
        """The reference's ``GradientMachine::getParameter``: the swig
        Parameter wrapper (below) over the i-th parameter."""
        names = self.parameters.keys()
        if not 0 <= i < len(names):
            raise RangeError(i)
        return Parameter(self.parameters, names[i])

    def getLayerOutputs(self, names):
        raise NotImplementedError(
            "fetch intermediate layers by adding them to output_layers")


class SequenceGenerator:
    """The reference's generation driver (``api/PaddleAPI.h:546``), over
    ``generation.SequenceGenerator`` on ``place`` (``CUDAPlace(0)`` unless
    the caller passes another; a RuntimeError where there is no card)."""

    def __init__(self, beam_gen, parameters, place=None):
        from paddle_tpu_torch.generation import SequenceGenerator as _Gen

        self._gen = _Gen(beam_gen, parameters, place=place)

    def generate(self, row):
        """One input row's beams, best first: [(score, [ids...]), ...]."""
        return self._gen.generate(row)


# ---------------------------------------------------------------------------
# SWIG numeric buffer types (reference: api/PaddleAPI.h Matrix:103,
# Vector:244, IVector:323 + api/Matrix.cpp / Vector.cpp).  numpy IS the
# buffer; `inplace` accessors return views, `copyTo*` return copies,
# exactly the py_paddle contract.
# ---------------------------------------------------------------------------


class UnsupportError(RuntimeError):
    """reference api/PaddleAPI.h:61"""


class RangeError(IndexError):
    """reference api/PaddleAPI.h:58"""


class Matrix:
    """Dense (numpy f32) or CSR-sparse 2-D buffer."""

    def __init__(self, arr=None, sparse=None, shape=None):
        self._arr = arr          # np (h, w) f32 when dense
        self._sparse = sparse    # (indptr, cols, vals|None) when sparse
        self._shape = shape if shape is not None else (
            arr.shape if arr is not None else (0, 0))

    # -- constructors ------------------------------------------------------
    @staticmethod
    def createZero(height, width, useGpu=False):
        return Matrix(np.zeros((height, width), np.float32))

    @staticmethod
    def createDense(data, height, width, useGpu=False):
        return Matrix(np.asarray(data, np.float32).reshape(height, width)
                      .copy())

    @staticmethod
    def createDenseFromNumpy(data, copy=True, useGpu=False):
        a = np.asarray(data, np.float32)
        if a.ndim != 2:
            raise UnsupportError("createDenseFromNumpy needs a 2-D array")
        return Matrix(a.copy() if copy else a)

    createCpuDenseFromNumpy = createDenseFromNumpy
    createGpuDenseFromNumpy = createDenseFromNumpy

    @staticmethod
    def createSparse(height, width, nnz, isNonVal=True, trans=False,
                     useGpu=False):
        m = Matrix(shape=(height, width))
        m._sparse = (np.zeros(height + 1, np.int64),
                     np.zeros(0, np.int64),
                     None if isNonVal else np.zeros(0, np.float32))
        return m

    def sparseCopyFrom(self, rows, cols, values=()):
        """CSR fill: ``rows`` = row offsets (len h+1), ``cols`` = column
        indices, ``values`` empty for binary (non-value) sparse."""
        if self._sparse is None:
            raise UnsupportError("sparseCopyFrom on a dense Matrix")
        vals = (np.asarray(values, np.float32) if len(values)
                else (None if self._sparse[2] is None
                      else np.zeros(len(cols), np.float32)))
        self._sparse = (np.asarray(rows, np.int64),
                        np.asarray(cols, np.int64), vals)

    # -- accessors ---------------------------------------------------------
    def isSparse(self):
        return self._sparse is not None

    def isGpu(self):
        return False

    def getHeight(self):
        return int(self._shape[0])

    def getWidth(self):
        return int(self._shape[1])

    def get(self, x, y):
        self._check_dense()
        if not (0 <= x < self._shape[0] and 0 <= y < self._shape[1]):
            raise RangeError((x, y))
        return float(self._arr[x, y])

    def set(self, x, y, val):
        self._check_dense()
        if not (0 <= x < self._shape[0] and 0 <= y < self._shape[1]):
            raise RangeError((x, y))
        self._arr[x, y] = val

    def getData(self):
        self._check_dense()
        return self._arr.ravel().tolist()

    def toNumpyMatInplace(self):
        self._check_dense()
        return self._arr

    def toNumpyMat(self):
        self._check_dense()
        return self._arr.copy()

    copyToNumpyMat = toNumpyMat

    def copyFromNumpyMat(self, data):
        self._check_dense()
        a = np.asarray(data, np.float32)
        if a.shape != self._arr.shape:
            raise RangeError((a.shape, self._arr.shape))
        self._arr[...] = a

    def getSparseRowCols(self, i):
        if self._sparse is None:
            raise UnsupportError("dense Matrix")
        indptr, cols, _ = self._sparse
        if not 0 <= i < self._shape[0]:
            raise RangeError(i)
        return cols[indptr[i]:indptr[i + 1]].tolist()

    def getSparseRowColsVal(self, i):
        if self._sparse is None or self._sparse[2] is None:
            raise UnsupportError("not a value-sparse Matrix")
        indptr, cols, vals = self._sparse
        if not 0 <= i < self._shape[0]:
            raise RangeError(i)
        sl = slice(indptr[i], indptr[i + 1])
        return list(zip(cols[sl].tolist(), vals[sl].tolist()))

    def _check_dense(self):
        if self._arr is None:
            raise UnsupportError("sparse Matrix has no dense buffer")


class _VectorBase:
    _dtype = np.float32

    def __init__(self, arr):
        self._arr = arr

    @classmethod
    def createZero(cls, sz, useGpu=False):
        return cls(np.zeros(sz, cls._dtype))

    @classmethod
    def create(cls, data, useGpu=False):
        return cls(np.asarray(data, cls._dtype).copy())

    @classmethod
    def createVectorFromNumpy(cls, data, copy=True, useGpu=False):
        a = np.asarray(data, cls._dtype)
        if a.ndim != 1:
            raise UnsupportError("vector needs a 1-D array")
        return cls(a.copy() if copy else a)

    @classmethod
    def createCpuVectorFromNumpy(cls, data, copy=True):
        return cls.createVectorFromNumpy(data, copy)

    @classmethod
    def createGpuVectorFromNumpy(cls, data):
        return cls.createVectorFromNumpy(data, True)

    def copyFrom(self, src):
        if src.getSize() != self.getSize():
            raise RangeError((src.getSize(), self.getSize()))
        self._arr[...] = src._arr

    def toNumpyArrayInplace(self):
        return self._arr

    def copyToNumpyArray(self):
        return self._arr.copy()

    def copyFromNumpyArray(self, data):
        a = np.asarray(data, self._dtype)
        if a.shape != self._arr.shape:
            raise RangeError((a.shape, self._arr.shape))
        self._arr[...] = a

    def get(self, idx):
        if not 0 <= idx < self._arr.size:
            raise RangeError(idx)
        return self._arr[idx].item()

    def set(self, idx, val):
        if not 0 <= idx < self._arr.size:
            raise RangeError(idx)
        self._arr[idx] = val

    def getData(self):
        return self._arr.tolist()

    def getSize(self):
        return int(self._arr.size)

    __len__ = getSize

    def isGpu(self):
        return False


class Vector(_VectorBase):
    """f32 1-D buffer (reference api/PaddleAPI.h:244)."""


class IVector(_VectorBase):
    """int 1-D buffer (reference api/PaddleAPI.h:323)."""

    _dtype = np.int32


# ---------------------------------------------------------------------------
# Parameter surface (reference: api/PaddleAPI.h ParameterConfig:498,
# Parameter:551, OptimizationConfig:528, ParameterOptimizer:685 +
# api/Parameter.cpp / ParameterOptimizer.cpp).
# ---------------------------------------------------------------------------


class ParameterConfig:
    """Proto-shaped view; toProtoString serializes as JSON (the repo's
    program-as-JSON redesign, PARITY §2.7)."""

    def __init__(self, name, dims):
        self.name = name
        self.dims = list(dims)

    def getName(self):
        return self.name

    def toProtoString(self):
        import json

        return json.dumps({"name": self.name, "dims": self.dims,
                           "size": int(np.prod(self.dims))}).encode()


class Parameter:
    """One named parameter over the v2 Parameters scope; getBuf returns
    a Vector VIEW (mutations write through, the swig contract)."""

    PARAMETER_VALUE = 0

    def __init__(self, v2_parameters, name):
        self._params = v2_parameters
        self._name = name

    def getName(self):
        return self._name

    def getSize(self):
        return int(np.prod(self._params.get_shape(self._name)))

    def getConfig(self):
        return ParameterConfig(self._name,
                               self._params.get_shape(self._name))

    def getBuf(self, which=PARAMETER_VALUE):
        arr = np.asarray(self._params.get(self._name), np.float32)
        flat = arr.reshape(-1).copy()
        v = Vector(flat)
        v._write_back = lambda: self._params.set(
            self._name, flat.reshape(arr.shape))
        return v

    def setBuf(self, vec):
        shape = self._params.get_shape(self._name)
        self._params.set(self._name,
                         np.asarray(vec._arr, np.float32).reshape(shape))


class OptimizationConfig:
    """Holds the optimizer config string consumed by the native C
    optimizer library (native/src/optimizer.cc; e.g. 'type=sgd lr=0.1'
    — the reference's OptimizationConfig proto equivalent)."""

    def __init__(self, config_str="type=sgd lr=0.01"):
        self.config = config_str

    @staticmethod
    def createFromProtoString(s):
        return OptimizationConfig(s.decode() if isinstance(s, bytes) else s)

    def toProtoString(self):
        return self.config.encode()


_OPT_TYPES = ("sgd", "adagrad", "adadelta", "adam", "rmsprop",
              "decayed_adagrad", "adamax")
_OPT_DEFAULTS = dict(type="sgd", lr=0.01, momentum=0.0, nesterov=False,
                     decay=0.0, epsilon=1e-6, rho=0.95, beta1=0.9,
                     beta2=0.999, lr_policy="const", lr_decay_a=0.0,
                     lr_decay_b=0.0)


def _parse_opt_config(s: str) -> dict:
    """``"type=adam lr=0.001 ..."`` as ``optimizer.cc:ParseConfig`` reads
    it: unknown keys and tokens without ``=`` are skipped."""
    c = dict(_OPT_DEFAULTS)
    for kv in s.split():
        if "=" not in kv:
            continue
        k, v = kv.split("=", 1)
        if k in ("type", "lr_policy"):
            c[k] = v
        elif k == "nesterov":
            c[k] = v in ("1", "true")
        elif k in c:
            c[k] = float(v)
    return c


class ParameterOptimizer:
    """One parameter's optimizer (the reference's api ParameterOptimizer
    over the native ``opt_create`` / ``opt_update``), its weights and
    state float32 tensors on ``place`` (``CUDAPlace(0)`` unless given).
    An unknown ``type`` is refused at ``init``, as ``opt_create``
    refuses it."""

    def __init__(self, opt_config, place=None):
        from paddle_tpu_torch.framework import resolve_place

        self._cfg = (opt_config.config
                     if isinstance(opt_config, OptimizationConfig)
                     else str(opt_config))
        self._device = resolve_place(place).device()
        self._c = None
        self._w = None

    @staticmethod
    def create(opt_config, place=None):
        return ParameterOptimizer(opt_config, place)

    def init(self, weights):
        """Bind the initial weights (a Vector, a numpy array or a list)."""
        c = _parse_opt_config(self._cfg)
        if c["type"] not in _OPT_TYPES:
            raise UnsupportError(f"bad optimizer config {self._cfg!r}")
        w = np.ascontiguousarray(
            weights._arr if isinstance(weights, _VectorBase) else weights,
            np.float32).reshape(-1)
        self._c = c
        self._w = torch.tensor(w, device=self._device)
        self._state = {}
        self._step = 0

    def _buf(self, name):
        if name not in self._state:
            self._state[name] = torch.zeros_like(self._w)
        return self._state[name]

    def _lr(self) -> float:
        """``Optimizer::LearningRate`` in double."""
        c = self._c
        if c["lr_policy"] == "linear":
            return max(c["lr"] - c["lr_decay_a"] * float(self._step),
                       c["lr_decay_b"])
        return c["lr"]

    def update(self, grad):
        """One step of the rule on the gradient (``Optimizer::Update``)."""
        if self._w is None:
            raise UnsupportError("init() first")
        g = torch.as_tensor(np.ascontiguousarray(
            grad._arr if isinstance(grad, _VectorBase) else grad,
            np.float32).reshape(-1)).to(self._device)
        if g.numel() != self._w.numel():
            raise RuntimeError("opt_update failed")
        c, w = self._c, self._w
        self._step += 1
        lr = self._lr()

        def f32(x):
            # a double cast to float, as a Python float torch reads exactly
            return float(np.float32(x))

        def one_minus(x):
            # (1 - x) in float, x a float
            return float(np.float32(1) - np.float32(x))

        flr, eps, rho = f32(lr), f32(c["epsilon"]), f32(c["rho"])
        b1, b2 = f32(c["beta1"]), f32(c["beta2"])
        g = g + f32(c["decay"]) * w
        if c["type"] == "sgd":
            if c["momentum"] != 0.0:
                m, mom = self._buf("momentum"), f32(c["momentum"])
                m.copy_(mom * m - flr * g)
                w += (mom * m - flr * g) if c["nesterov"] else m
            else:
                w -= flr * g
        elif c["type"] == "adagrad":
            a = self._buf("accum")
            a += g * g
            w -= flr * g / (torch.sqrt(a) + eps)
        elif c["type"] == "adadelta":
            ag, ad = self._buf("accum_g"), self._buf("accum_d")
            ag.copy_(rho * ag + one_minus(rho) * g * g)
            dx = -torch.sqrt((ad + eps) / (ag + eps)) * g
            ad.copy_(rho * ad + one_minus(rho) * dx * dx)
            w += flr * dx
        elif c["type"] == "rmsprop":
            m = self._buf("mean_square")
            m.copy_(rho * m + one_minus(rho) * g * g)
            w -= flr * g / (torch.sqrt(m) + eps)
        elif c["type"] == "decayed_adagrad":
            a = self._buf("accum")
            a.copy_(rho * a + one_minus(rho) * g * g)
            w -= flr * g / (torch.sqrt(a) + eps)
        elif c["type"] == "adamax":
            m1, inf = self._buf("m1"), self._buf("inf_norm")
            alpha = f32(lr / (1.0 - math.pow(c["beta1"], float(self._step))))
            m1.copy_(b1 * m1 + one_minus(b1) * g)
            inf.copy_(torch.maximum(b2 * inf, torch.abs(g)))
            w -= alpha * m1 / (inf + eps)
        else:  # adam
            m1, m2 = self._buf("m1"), self._buf("m2")
            bc1 = 1.0 - math.pow(c["beta1"], float(self._step))
            bc2 = 1.0 - math.pow(c["beta2"], float(self._step))
            alpha = f32(lr * math.sqrt(bc2) / bc1)
            m1.copy_(b1 * m1 + one_minus(b1) * g)
            m2.copy_(b2 * m2 + one_minus(b2) * g * g)
            w -= alpha * m1 / (torch.sqrt(m2) + eps)

    def getWeights(self):
        return Vector(self._w.cpu().numpy().copy())
