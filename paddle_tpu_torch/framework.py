"""Program-as-data IR, the PyTorch port's copy.

The same Variable / Parameter / Operator / Block / Program objects as
the JAX package's ``paddle_tpu/framework.py``, with the same
``to_dict``/``from_dict`` wire format, so a ``__model__.json`` written
by either package loads in the other.  Places select a torch device:
``CPUPlace()`` or ``CUDAPlace(id)``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Places.  A Place names the torch device the Executor runs a program on.
# ---------------------------------------------------------------------------


class Place:
    def device(self) -> torch.device:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__ + "()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self).__name__)


class CPUPlace(Place):
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card, by index."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"

    def __eq__(self, other):
        return isinstance(other, CUDAPlace) and other.device_id == self.device_id

    def __hash__(self):
        return hash(("CUDAPlace", self.device_id))


def resolve_place(place: Optional[Place]) -> Place:
    """The entry points' place rule: the card unless the caller asks for
    the CPU, and never a quiet fall back to the CPU."""
    place = CUDAPlace(0) if place is None else place
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} requested but torch finds no CUDA device; pass "
                "CPUPlace() to run on the CPU")
        if place.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{place!r} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) exist")
    return place


# ---------------------------------------------------------------------------
# Data types (the framework.proto DataType names).
# ---------------------------------------------------------------------------

_DTYPE_CANON = {
    "bool", "int8", "uint8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
}


def convert_dtype(dtype) -> str:
    """Canonicalize a dtype spec (str / np.dtype / torch.dtype) to a string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    name = {"float": "float32", "double": "float64", "int": "int32"}.get(name, name)
    if name not in _DTYPE_CANON:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def is_float_dtype(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")


# ---------------------------------------------------------------------------
# Unique names
# ---------------------------------------------------------------------------


class _UniqueNameGenerator:
    def __init__(self):
        self.ids = collections.defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{tmp}"


_name_gen = _UniqueNameGenerator()


def unique_name(key: str) -> str:
    return _name_gen(key)


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class VarType:
    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


class Variable:
    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype="float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        type: str = VarType.LOD_TENSOR,
    ):
        self.block = block
        self.name = name if name is not None else unique_name("_generated_var")
        # unknown dims may be given as None (normalized to -1)
        self.shape = (
            tuple(-1 if s is None else int(s) for s in shape)
            if shape is not None else None
        )
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, dtype={self.dtype},"
            f" lod_level={self.lod_level}, persistable={self.persistable})"
        )

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }


class Parameter(Variable):
    """A trainable, persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip = kwargs.pop("gradient_clip", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        super().__init__(block, shape=shape, dtype=dtype, persistable=True,
                         **kwargs)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


def _as_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class _AttrDict(dict):
    """Op attrs that version-bump the owning program on mutation, so the
    executor's cache can see in-place attr edits (e.g. flipping
    ``is_test`` by hand) without rehashing the program every run."""

    __slots__ = ("_op",)

    def __init__(self, op, mapping=None):
        super().__init__(mapping or {})
        self._op = op

    def _touch(self):
        block = getattr(self._op, "block", None)
        prog = getattr(block, "program", None) if block is not None else None
        if prog is not None:
            prog._version = getattr(prog, "_version", 0) + 1

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._touch()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._touch()

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self._touch()

    def pop(self, *a):
        out = super().pop(*a)
        self._touch()
        return out

    def setdefault(self, k, default=None):
        out = super().setdefault(k, default)
        self._touch()
        return out

    def clear(self):
        super().clear()
        self._touch()

    def popitem(self):
        out = super().popitem()
        self._touch()
        return out

    def __ior__(self, other):  # ``attrs |= {...}`` bypasses update()
        super().update(other)
        self._touch()
        return self

    def __deepcopy__(self, memo):
        new = _AttrDict.__new__(_AttrDict)
        dict.__init__(new)
        memo[id(self)] = new  # before the _op recursion re-enters us
        new._op = copy.deepcopy(self._op, memo)
        for k, v in self.items():
            dict.__setitem__(new, k, copy.deepcopy(v, memo))
        return new


class Operator:
    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            k: _as_name_list(v) for k, v in (inputs or {}).items()
        }
        self.outputs: Dict[str, List[str]] = {
            k: _as_name_list(v) for k, v in (outputs or {}).items()
        }
        self._attrs: Dict[str, Any] = _AttrDict(self, attrs or {})
        # registry-side infer_shape at append time, like the reference's
        # compile-time InferShape
        from paddle_tpu_torch import registry

        info = registry.OpRegistry.get(type, none_ok=True)
        if info is not None and info.infer_shape is not None:
            try:
                info.infer_shape(self, block)
            except registry.SkipInferShape:
                pass

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    @property
    def attrs(self) -> Dict[str, Any]:
        return self._attrs

    @attrs.setter
    def attrs(self, mapping):
        if isinstance(mapping, _AttrDict) and mapping._op is self:
            self._attrs = mapping
        else:
            self._attrs = _AttrDict(self, dict(mapping or {}))
        self._attrs._touch()

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        def _attr_ser(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v

        def _ser(k, v):
            # a grad op's copy of its forward's attrs holds the forward's
            # sub-block (recurrent_grad's): the same reference, one level
            # down, so the dict stays JSON and loads back in from_dict
            if k == "__fwd_attrs__" and isinstance(v, dict):
                return {kk: _attr_ser(vv) for kk, vv in v.items()}
            return _attr_ser(v)

        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: _ser(k, v) for k, v in self.attrs.items()},
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs})}}"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = collections.OrderedDict()
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs) -> Variable:
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, shape, dtype, **kwargs) -> Parameter:
        # parameters always live in the root block
        global_block = self.program.blocks[0]
        param = Parameter(global_block, shape, dtype, **kwargs)
        global_block.vars[param.name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        """Parent-chain lookup."""
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {k: v.to_dict() for k, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.seed: Optional[int] = None  # program-level RNG seed
        self._version = 0  # bumped on in-place op-attr mutation

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block whose parent is the current block (or
        ``parent_idx``); it becomes the current block."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    # --- serialization / identity ------------------------------------------

    def to_dict(self):
        return {
            "blocks": [b.to_dict() for b in self.blocks],
            "seed": self.seed,
        }

    def to_string(self, throw_on_error: bool = False) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    __str__ = to_string

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Program":
        """Rebuild a Program from ``to_dict`` output (the wire format of
        ``save_inference_model``'s ``__model__.json``)."""
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p.seed = d.get("seed")
        p._version = 0
        for bd in d["blocks"]:
            p.blocks.append(Block(p, bd["idx"], bd["parent_idx"]))
        for bd, b in zip(d["blocks"], p.blocks):
            for name, vd in bd["vars"].items():
                if vd.get("is_parameter"):
                    var = Parameter(b, vd["shape"], vd["dtype"], name=name)
                else:
                    var = Variable(
                        b, name=name, shape=vd["shape"], dtype=vd["dtype"],
                        lod_level=vd.get("lod_level", 0),
                        persistable=vd.get("persistable", False),
                        stop_gradient=vd.get("stop_gradient", False),
                        type=vd.get("type", VarType.LOD_TENSOR))
                b.vars[name] = var
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if k == "__fwd_attrs__" and isinstance(v, dict):
                        v = {kk: _attr_de(p, vv) for kk, vv in v.items()}
                    attrs[k] = _attr_de(p, v)
                op = Operator.__new__(Operator)
                op.block = b
                op.type = od["type"]
                op.inputs = {k: list(v) for k, v in od["inputs"].items()}
                op.outputs = {k: list(v) for k, v in od["outputs"].items()}
                op.attrs = _AttrDict(op, attrs)
                b.ops.append(op)
        return p

    def fingerprint(self) -> str:
        """Stable content hash; the executor-cache key component."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()

    def cache_key(self) -> str:
        """``fingerprint()``, recomputed only when the op/var counts or
        the attr-mutation version change."""
        counts = (tuple((len(b.ops), len(b.vars)) for b in self.blocks),
                  getattr(self, "_version", 0))
        cached = getattr(self, "_fp_cache", None)
        if cached is not None and cached[0] == counts:
            return cached[1]
        fp = self.fingerprint()
        self._fp_cache = (counts, fp)
        return fp

    def invalidate_cache(self):
        """Drop the cached fingerprint."""
        if hasattr(self, "_fp_cache"):
            del self._fp_cache

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program.  With ``for_test=True``, flips ops with
        an ``is_test`` attribute into inference mode and strips
        training-only ops."""
        p = copy.deepcopy(self)
        p.invalidate_cache()
        if for_test:
            for block in p.blocks:
                for op in block.ops:
                    if op.type in _OPS_WITH_IS_TEST:
                        op.attrs["is_test"] = True
                block.ops = [op for op in block.ops
                             if not _is_training_only_op(op)]
        return p

    def prune(self, targets) -> "Program":
        """Dead-op elimination given fetch targets: keeps the ops whose
        outputs (transitively) feed a target, and ``feed`` ops.  A kept
        op that owns a sub-block also keeps every variable the sub-block
        reads from the enclosing scope (``_sub_block_external_reads``),
        even where the op's own inputs do not name it."""
        needed = set(_as_name_list(targets))
        p = self.clone()
        block = p.global_block()
        kept: List[Operator] = []
        for op in reversed(block.ops):
            if needed & set(op.output_arg_names) or op.type == "feed":
                kept.append(op)
                needed |= set(op.input_arg_names)
                needed |= _sub_block_external_reads(op)
        block.ops = list(reversed(kept))
        p._version += 1
        p.invalidate_cache()
        return p


def _attr_de(program: Program, v):
    """An attr value of ``to_dict`` output as the op holds it: a block
    reference (``{"__block__": idx}``) as this program's block of that
    index, an ``{"__ndarray__"}`` dict as a numpy array."""
    if isinstance(v, dict) and "__block__" in v:
        return program.blocks[v["__block__"]]
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


def _sub_block_external_reads(op) -> set:
    """Variables an op's sub-blocks (Block-valued attrs) read from the
    enclosing scope: the union of the sub-block ops' inputs
    (recursively) less the names produced inside the sub-block before
    they are read (``paddle_tpu/framework.py:598-611``)."""
    reads: set = set()
    for v in op.attrs.values():
        if not isinstance(v, Block):
            continue
        produced: set = set()
        for sub_op in v.ops:
            reads |= set(sub_op.input_arg_names) - produced
            reads |= _sub_block_external_reads(sub_op)
            produced |= set(sub_op.output_arg_names)
    reads.discard("")
    return reads


_OPS_WITH_IS_TEST = frozenset({"dropout", "batch_norm"})

# Parameter-update op types; clone(for_test) must drop them so test runs
# don't train.
_OPTIMIZER_OP_TYPES = frozenset({
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
})


def _is_training_only_op(op) -> bool:
    if op.attrs.get("op_role") == "optimize":
        return True
    if op.type in _OPTIMIZER_OP_TYPES:
        return True
    if any("@GRAD" in name for name in op.output_arg_names):
        return True
    # LR-scheduler global-step bump
    if op.type == "increment" and any(
            "@lr_global_step@" in n for n in op.output_arg_names):
        return True
    return False


# ---------------------------------------------------------------------------
# Default programs + guards
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def reset_default_programs():
    """Fresh default programs + name counter (used by tests)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    _name_gen.ids.clear()
