"""Op registry: ops as lowering rules over torch tensors.

An op is a Python function that, given a ``LowerContext`` holding the
tensors of its inputs, computes the tensors of its outputs.  The
Executor calls the rules eagerly, one op after another.  The registry
has the JAX package's shape (``paddle_tpu/registry.py``).

Gradients: an op may register an explicit ``grad_lower`` /
``grad_maker``; otherwise ``append_backward`` emits a ``<type>_grad`` op
whose rule replays the forward rule under autograd and pulls the
cotangents through (``autodiff.generic_grad_lower``).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, List, Optional, Sequence


class SkipInferShape(Exception):
    """Raised by infer_shape rules that cannot infer statically."""


def infer_same_shape(op, block):
    """Shared infer_shape for elementwise/unary ops: Out mirrors X.

    Fills in missing output metadata (shape/lod) from the single X
    input; raises ``SkipInferShape`` when the pattern doesn't apply."""
    xs = op.inputs.get("X", [])
    outs = op.outputs.get("Out", [])
    if len(xs) != 1 or len(outs) != 1 or not xs[0] or not outs[0]:
        raise SkipInferShape
    xv = block.find_var(xs[0])
    ov = block.find_var(outs[0])
    if xv is None or ov is None:
        raise SkipInferShape
    if ov.shape is None and xv.shape is not None:
        ov.shape = tuple(xv.shape)
    if ov.lod_level == 0 and xv.lod_level:
        ov.lod_level = xv.lod_level


@dataclasses.dataclass
class OpInfo:
    type: str
    lower: Callable[["LowerContext"], None]
    infer_shape: Optional[Callable] = None
    input_slots: Sequence[str] = ()
    output_slots: Sequence[str] = ()
    # which input slots are differentiable (None = all float inputs)
    diff_inputs: Optional[Sequence[str]] = None
    # explicit grad lowering: fn(ctx) for op "<type>_grad"
    grad_lower: Optional[Callable[["LowerContext"], None]] = None
    # explicit grad maker: fn(op, block, no_grad_set) -> (type, inputs,
    # outputs, attrs) or None.  None -> the default maker of backward.py.
    grad_maker: Optional[Callable] = None
    # ops with no gradient at all (metrics, fill, random init, ...)
    stop_gradient: bool = False
    # why the op cannot run inside a captured CUDA graph (None: it can):
    # it reads device values on the host, sizes an output by them, or
    # copies host data to the card on every run.  A string, or a
    # function of the op giving one or None where it depends on the op's
    # inputs or attrs (``host_sync_reason``).  The Executor runs a plan
    # holding such an op eagerly and records this reason.
    host_sync: Any = None


def host_sync_reason(info: OpInfo, op) -> Optional[str]:
    """Why ``op`` (of registry entry ``info``) cannot be captured in a
    CUDA graph, or None."""
    if callable(info.host_sync):
        return info.host_sync(op)
    return info.host_sync


class OpRegistry:
    _ops: Dict[str, OpInfo] = {}

    @classmethod
    def register(cls, info: OpInfo):
        if info.type in cls._ops:
            raise ValueError(f"op {info.type!r} already registered")
        cls._ops[info.type] = info

    @classmethod
    def get(cls, type: str, none_ok: bool = False) -> Optional[OpInfo]:
        info = cls._ops.get(type)
        if info is None and type.endswith("_grad") and type[:-5] in cls._ops:
            from paddle_tpu_torch.autodiff import synthesize_grad_info

            info = synthesize_grad_info(type)
        if info is None and not none_ok:
            msg = f"op {type!r} is not registered in paddle_tpu_torch"
            close = cls.suggest(type, n=1)
            if close:
                msg += f"; did you mean {close[0]!r}?"
            raise KeyError(msg)
        return info

    @classmethod
    def suggest(cls, type: str, n: int = 3) -> List[str]:
        """Closest registered op names (for did-you-mean diagnostics); a
        mistyped grad op suggests the registered forward's grad form."""
        candidates = list(cls._ops)
        if type.endswith("_grad"):
            candidates += [op + "_grad" for op in cls._ops]
        return difflib.get_close_matches(type, candidates, n=n, cutoff=0.6)

    @classmethod
    def has(cls, type: str) -> bool:
        return type in cls._ops

    @classmethod
    def all_ops(cls) -> List[str]:
        return sorted(cls._ops)


def register_op(
    type: str,
    *,
    inputs: Sequence[str] = (),
    outputs: Sequence[str] = ("Out",),
    infer_shape=None,
    diff_inputs=None,
    grad_lower=None,
    grad_maker=None,
    stop_gradient: bool = False,
    host_sync: Any = None,
):
    """Decorator: ``@register_op("relu", inputs=["X"])`` on a lowering fn."""

    def deco(fn):
        OpRegistry.register(
            OpInfo(
                type=type,
                lower=fn,
                infer_shape=infer_shape,
                input_slots=tuple(inputs),
                output_slots=tuple(outputs),
                diff_inputs=(tuple(diff_inputs) if diff_inputs is not None
                             else None),
                grad_lower=grad_lower,
                grad_maker=grad_maker,
                stop_gradient=stop_gradient,
                host_sync=host_sync,
            )
        )
        return fn

    return deco


class LowerContext:
    """What a lowering rule sees: the op, the name -> tensor map of the
    run, the run's device (where source ops such as fill_constant put
    their outputs) and its ``torch.Generator`` for random ops."""

    def __init__(self, op, values: Dict[str, Any], device=None,
                 generator=None):
        self.op = op
        self.values = values
        self.device = device
        self._generator = generator

    # --- inputs ------------------------------------------------------------

    def has_input(self, slot: str) -> bool:
        names = self.op.input(slot)
        return bool(names) and all(n in self.values for n in names)

    def input(self, slot: str):
        names = self.op.input(slot)
        if not names:
            return None
        if len(names) != 1:
            raise ValueError(f"op {self.op.type}: slot {slot} has {len(names)} args")
        return self.values[names[0]]

    def inputs(self, slot: str) -> List[Any]:
        """Every argument of a multi-argument slot (``sum``'s X)."""
        return [self.values[n] for n in self.op.input(slot)]

    # --- outputs -----------------------------------------------------------

    def has_output(self, slot: str) -> bool:
        return bool(self.op.output(slot))

    def set_output(self, slot: str, value):
        names = self.op.output(slot)
        if not names:
            return  # optional output not wired up in this program
        if len(names) != 1:
            raise ValueError(
                f"op {self.op.type}: slot {slot} expects 1 output, has {names}"
            )
        self.values[names[0]] = value

    # --- attrs / misc ------------------------------------------------------

    def attr(self, name: str, default=None):
        return self.op.attr(name, default)

    def generator_or_none(self):
        """The run's ``torch.Generator``, or None where the run has none."""
        return self._generator

    def generator(self):
        """The run's ``torch.Generator`` (random ops draw from it)."""
        if self._generator is None:
            raise RuntimeError(
                f"op {self.op.type} needs RNG but the executor gave none")
        return self._generator
