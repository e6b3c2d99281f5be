"""Eager Executor.

Interprets a block op by op on torch tensors, the way the reference
Executor interprets a block against device memory.  Per (program
fingerprint, feed signature, fetch names, place) it caches the
classified op list: which persistables the block reads (the state,
taken from the Scope), which it writes back, each op's registry entry,
and each value's last reader.  Persistables an op writes go back into
the Scope after the run.

Values die young: once the last op that reads a value has run, the run
drops it, unless it is persistable, fed or fetched.  XLA's buffer
liveness does this for the JAX package.  Eagerly, holding every
activation and every activation gradient of a ResNet-50 train step to
the end of the run would need about twice the forward's values.  A
residual that an op leaves for its grad rule under a name no op declares
(the attention forward's logsumexp) is popped by that rule, or dies with
the run's value map; it never reaches the Scope.

An op that owns a sub-block (``recurrent``'s step block, a ``while`` or
``conditional_block`` body) reads what its sub-block reads from the
enclosing scope, whether or not its own inputs name it (``op_reads``),
and runs the sub-block's ops on a values map of its own
(``run_block``).  What the sub-block writes to the enclosing scope the
op lists as its outputs (``While``'s Out), so the release plan keeps
each such value until the op has run.  Values of other kinds than
tensors (a ``TensorArray``, a ``LoDRankTable``) pass through the plan
and the values map as they are.

On a CUDA place every run holds float32 math at float32: TF32 is off for
cuDNN and matmul, and so are bf16 matmuls' reduced-precision
reductions, while any run is in flight (``_f32_math``), so the library
calls that the kernels leave to PyTorch (the stride-2 convs, the mul
backward's products) round like the kernels do.

AMP (``paddle_tpu_torch.amp``) is read once per run: the forward ops and
the grad ops of one run see the same state, and the plan cache is keyed
on it, as the JAX Executor's compile cache is.

Every run records the JAX Executor's seven metric families, with its
names and label keys (``paddle_tpu_torch.observability``), labelled by
``program``, the first 12 hex digits of ``Program.fingerprint()``.  A
plan-cache miss or hit counts with ``source="plan"``: the port builds an
op plan where the JAX package traces and compiles.  ``executor_step_seconds``
is host dispatch (CUDA runs asynchronously); ``executor_fetch_seconds``
holds the device-to-host sync.  ``FLAGS.trace_ops`` runs each op inside
``torch.profiler.record_function(op.type)`` and keys the plan cache;
``FLAGS.check_program`` raises, since the static verifier is not ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import amp, framework
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import Place, Program, Variable
from paddle_tpu_torch.lod import LoDArray, LoDRankTable, create_lod_array
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.events import GLOBAL_EVENTS as _EVENTS
from paddle_tpu_torch.ops.common import torch_dtype
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from paddle_tpu_torch.sparse import SparseGrad
from paddle_tpu_torch.tensor_array import TensorArray


# ---------------------------------------------------------------------------
# Telemetry: the JAX Executor's families (paddle_tpu/executor.py:59-84),
# keyed by program fingerprint so GET /metrics attributes cost per program
# ---------------------------------------------------------------------------

_M_CACHE_MISS = _metrics.counter(
    "executor_compile_cache_miss_total",
    "Executor.run plan-cache misses, by how the plan was produced "
    "(source=plan: the block's ops classified into a run plan)")
_M_CACHE_HIT = _metrics.counter(
    "executor_compile_cache_hit_total",
    "Executor.run plan-cache hits (cached run plan reused), labeled by "
    "the plan's source (plan)")
_M_COMPILE_SEC = _metrics.histogram(
    "executor_compile_seconds",
    "wall time per plan-cache miss: the plan build",
    buckets=_metrics.COMPILE_TIME_BUCKETS)
_M_FEED_SEC = _metrics.histogram(
    "executor_feed_convert_seconds",
    "host-side feed-dict conversion time per run")
_M_STEP_SEC = _metrics.histogram(
    "executor_step_seconds",
    "step dispatch wall time on the host (CUDA runs asynchronously; "
    "cached='miss' rows follow a plan build)")
_M_FETCH_SEC = _metrics.histogram(
    "executor_fetch_seconds",
    "fetch materialization (device->host sync) time per run")
_M_FETCH_BYTES = _metrics.counter(
    "executor_fetch_device_to_host_bytes_total",
    "bytes copied device->host materializing return_numpy fetches")

#: Where the port's static verifier will come from (ROADMAP Queue 1).
_CHECK_PROGRAM_ITEM = (
    "paddle_tpu_torch: FLAGS.check_program needs the static verifier "
    "(analysis/), which ROADMAP Queue 1 item 3 queues behind CUDA graphs "
    "and the rest of the executor; unset the flag to run unverified")


def _fetch_nbytes(v) -> int:
    """Host bytes a fetch converted to numpy occupies."""
    if isinstance(v, LoDArray):
        return v.data.nbytes + sum(o.nbytes for o in v.lod)
    if isinstance(v, SparseGrad):
        return v.rows.nbytes + v.values.nbytes
    if isinstance(v, TensorArray):
        return v.stack.nbytes + v.length.nbytes
    return getattr(v, "nbytes", 0)


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------


class _VarHolder:
    """``scope.var(name).get_tensor()``, as the reference's scope offers
    it."""

    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self._scope.values.get(self._name)

    def set(self, value, place=None):
        """Store ``value`` as a tensor on ``place`` (``CUDAPlace(0)``
        unless the caller passes another)."""
        device = framework.resolve_place(place).device()
        self._scope.values[self._name] = (
            value.to(device) if isinstance(value, torch.Tensor)
            else tensor_from_numpy(value, device))


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``, dtype kept; a bf16 array (the
    ``ml_dtypes`` bfloat16 the JAX package hands out) through its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device=device, copy=True)
    return torch.tensor(arr, device=device)


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """The port's state from parameters read as numpy (from the JAX
    package's scope or from an export): one tensor per name on
    ``device``, dtype kept, copied (the arrays may be read-only views of
    another framework's buffers)."""
    return {name: tensor_from_numpy(arr, device)
            for name, arr in arrays.items()}


class Scope:
    """Name -> tensor map with parent-chain lookup."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.values: Dict[str, Any] = {}

    def new_scope(self) -> "Scope":
        # the child links to its parent only: a scope left by
        # leave_local_scope is freed with its tensors
        return Scope(self)

    def var(self, name: str) -> _VarHolder:
        return _VarHolder(self, name)

    def find_var(self, name: str) -> Optional[_VarHolder]:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.values:
                return _VarHolder(s, name)
            s = s.parent
        return None

    def get(self, name: str, default=None):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.values:
                return s.values[name]
            s = s.parent
        return default

    def set(self, name: str, value):
        self.values[name] = value

    def load_numpy(self, arrays: Dict[str, np.ndarray], device) -> None:
        """Set every array as a tensor on ``device`` (``params_from_numpy``)."""
        self.values.update(params_from_numpy(arrays, device))

    def __contains__(self, name: str) -> bool:
        return self.get(name) is not None

    def keys(self):
        return self.values.keys()


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


# ---------------------------------------------------------------------------
# float32 policy on CUDA
# ---------------------------------------------------------------------------

_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = None


@contextlib.contextmanager
def _f32_math():
    """TF32 off for cuDNN and matmul, and bf16 matmuls' reduced-precision
    reductions off (cuBLAS then sums bf16 products in float32 throughout),
    while at least one run is inside.  The flags are process-global, so
    concurrent runs (serving replicas are threads) share one
    save/restore: the first in sets, the last out restores."""
    global _f32_depth, _f32_saved
    matmul = torch.backends.cuda.matmul
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
                          matmul.allow_bf16_reduced_precision_reduction)
            torch.backends.cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
                 matmul.allow_bf16_reduced_precision_reduction) = _f32_saved


# ---------------------------------------------------------------------------
# Feeds
# ---------------------------------------------------------------------------


def _convert_tensor(value, var: Optional[Variable], device) -> torch.Tensor:
    dtype = torch_dtype(var.dtype) if var is not None else None
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    arr = np.asarray(value)
    if var is not None and var.dtype != "bfloat16":
        arr = arr.astype(var.dtype, copy=False)
    return tensor_from_numpy(arr, device).to(dtype=dtype)


def _convert_feed(value, var: Optional[Variable], device):
    """A feed as a tensor on ``device``; a LoD feed (a ``LoDArray`` or an
    ``(array, [offsets, ...])`` tuple, as ``paddle_tpu/executor.py:203-209``
    takes it) as a LoDArray with int32 offsets there."""
    if isinstance(value, tuple) and len(value) == 2 and isinstance(
            value[1], (list, tuple)):
        value = create_lod_array(np.asarray(value[0]), value[1])
    if isinstance(value, LoDArray):
        return LoDArray(_convert_tensor(value.data, var, device),
                        tuple(torch.as_tensor(o, device=device).to(torch.int32)
                              for o in value.lod))
    return _convert_tensor(value, var, device)


def _feed_signature(feed_vals: Dict[str, Any]):
    sig = []
    for name in sorted(feed_vals):
        v = feed_vals[name]
        if isinstance(v, LoDArray):
            sig.append((name, "lod", tuple(v.data.shape), str(v.data.dtype),
                        tuple(tuple(o.shape) for o in v.lod)))
        else:
            sig.append((name, tuple(v.shape), str(v.dtype)))
    return tuple(sig)


def _numpy_bf16():
    """``ml_dtypes``' bfloat16, numpy's bf16 dtype where that package is
    installed (the JAX package's fetches use it), else None."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def _to_numpy(v):
    """A fetch as numpy; a bf16 tensor as an ``ml_dtypes`` bfloat16 array
    of its bits, the dtype the reference fetches (``np.asarray`` of a
    bf16 jax array), or, without ``ml_dtypes``, as the float32 array of
    the same values.  A ``SparseGrad`` (an ``is_sparse`` table's W@GRAD)
    comes back as one of numpy rows and values, a ``TensorArray`` or a
    ``LoDRankTable`` as one of numpy fields."""
    if isinstance(v, TensorArray):
        return TensorArray(_to_numpy(v.stack), _to_numpy(v.length))
    if isinstance(v, LoDRankTable):
        return LoDRankTable(_to_numpy(v.index), _to_numpy(v.lengths),
                            _to_numpy(v.offsets), v.src_rows)
    if isinstance(v, LoDArray):
        return LoDArray(_to_numpy(v.data), tuple(_to_numpy(o) for o in v.lod))
    if isinstance(v, SparseGrad):
        # numpy rows and values, as ``paddle_tpu/executor.py:436-441``
        return SparseGrad(_to_numpy(v.rows), _to_numpy(v.values), v.height)
    v = v.detach()
    if v.dtype == torch.bfloat16:
        bf16 = _numpy_bf16()
        if bf16 is None:
            return v.float().cpu().numpy()
        return v.cpu().view(torch.int16).numpy().view(bf16)
    return v.cpu().numpy()


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


_RANDOM_OPS = frozenset({"uniform_random", "gaussian_random", "dropout",
                         "nce", "sampling_id"})


class _Plan:
    """A classified block: the state it reads, the persistables it
    writes, each op with its registry entry and the values to drop once
    it has run."""

    __slots__ = ("ops", "state_names", "written_names", "fetch_names",
                 "uses_rng")

    def __init__(self, ops, state_names, written_names, fetch_names, uses_rng):
        self.ops = ops    # [(op, OpInfo, names to release after it)]
        self.state_names = state_names
        self.written_names = written_names
        self.fetch_names = fetch_names
        self.uses_rng = uses_rng


def run_block(block, values: Dict[str, Any], device=None,
              generator=None) -> None:
    """Run ``block``'s ops in order on ``values`` (name -> tensor), which
    they read and write: how an op that owns a sub-block runs it, the
    counterpart of ``paddle_tpu/ops/control_flow_ops.py:32-35``."""
    for op in block.ops:
        OpRegistry.get(op.type).lower(
            LowerContext(op, values, device, generator))


def op_reads(op) -> List[str]:
    """The names ``op`` reads: its inputs, then what its sub-blocks read
    from the enclosing scope (``framework._sub_block_external_reads``,
    less the sub-blocks' own variables, which the op sets itself: a
    step input, a memory)."""
    names = [n for n in op.input_arg_names if n]
    extra = framework._sub_block_external_reads(op).difference(names)
    return names + sorted(n for n in extra
                          if op.block.find_var(n) is not None)


class Executor:
    """Eager op-by-op executor on one place: ``CUDAPlace(0)`` unless the
    caller passes another, and a RuntimeError rather than a quiet CPU
    run when there is no card.  ``strategy`` (the JAX package's
    data/tensor/sequence-parallel mesh, through which its attention op
    turns into ring attention) waits for the parallel slice."""

    def __init__(self, place: Optional[Place] = None, strategy=None):
        if strategy is not None:
            raise NotImplementedError(
                "paddle_tpu_torch: parallel strategies (data, tensor and "
                "sequence parallel meshes, ring attention) come with the "
                "parallel slice")
        self.place = framework.resolve_place(place)
        self.device = self.place.device()
        self._cache: Dict[Any, _Plan] = {}
        self._lock = threading.Lock()
        self._step = 0

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = tuple(
            v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or []))
        if FLAGS.get("check_program"):
            raise NotImplementedError(_CHECK_PROGRAM_ITEM)
        block = program.global_block()
        fp = program.cache_key()
        prog_label = fp[:12]

        t_feed = time.perf_counter()
        feed_vals = {name: _convert_feed(v, block.find_var(name), self.device)
                     for name, v in feed.items()}
        _M_FEED_SEC.observe(time.perf_counter() - t_feed, program=prog_label)

        amp_on = amp.is_enabled()
        trace_ops = bool(FLAGS.get("trace_ops"))
        key = (fp, _feed_signature(feed_vals), fetch_names, self.place,
               amp_on, trace_ops)
        plan = self._cache.get(key)
        cache_hit = plan is not None
        if cache_hit:
            _M_CACHE_HIT.inc(program=prog_label, source="plan")
        else:
            _M_CACHE_MISS.inc(program=prog_label, source="plan")
            t_plan = time.perf_counter()
            with _EVENTS.span("executor.compile", program=prog_label):
                plan = self._classify(program, feed_vals, fetch_names)
            self._cache[key] = plan
            _M_COMPILE_SEC.observe(time.perf_counter() - t_plan,
                                   program=prog_label)

        values: Dict[str, Any] = {}
        missing = []
        for n in plan.state_names:
            v = scope.get(n)
            if v is None:
                missing.append(n)
            values[n] = v
        if missing:
            raise RuntimeError(
                f"persistable variables not initialized in scope: {missing}; "
                "run the startup program first")
        values.update(feed_vals)

        generator = None
        if plan.uses_rng:
            with self._lock:
                self._step += 1
                step = self._step
            seed = (program.seed or 0) * 1000003 + step
            generator = torch.Generator(device=self.device).manual_seed(seed)

        math = (_f32_math() if self.device.type == "cuda"
                else contextlib.nullcontext())
        tag = "hit" if cache_hit else "miss"
        ev_t0 = _EVENTS.now()
        t_step = time.perf_counter()
        with torch.no_grad(), math, amp.amp_guard(amp_on):
            for op, info, release in plan.ops:
                ctx = LowerContext(op, values, self.device, generator)
                if trace_ops:
                    with torch.profiler.record_function(op.type):
                        info.lower(ctx)
                else:
                    info.lower(ctx)
                for n in release:
                    values.pop(n, None)
        dt_step = time.perf_counter() - t_step
        _M_STEP_SEC.observe(dt_step, program=prog_label, cached=tag)
        _EVENTS.complete("executor.step", ev_t0, dt_step,
                         program=prog_label, cached=tag)
        for n in plan.written_names:
            scope.set(n, values[n])
        fetches = [values[n] for n in plan.fetch_names]
        if not return_numpy:
            return fetches
        t_fetch = time.perf_counter()
        out = [_to_numpy(v) for v in fetches]
        if out:
            _M_FETCH_SEC.observe(time.perf_counter() - t_fetch,
                                 program=prog_label)
            nbytes = sum(_fetch_nbytes(v) for v in out)
            if nbytes:
                _M_FETCH_BYTES.inc(nbytes, program=prog_label)
        return out

    @staticmethod
    def _classify(program: Program, feed_vals: Dict[str, Any],
                  fetch_names: Sequence[str]) -> _Plan:
        """Persistables an op reads before any op writes them come from
        the scope; every other input must be fed or produced earlier."""
        block = program.global_block()
        read_state: List[str] = []
        written_state: List[str] = []
        produced: set = set(feed_vals)
        uses_rng = False
        ops = []
        for op in block.ops:
            if op.type in ("feed", "fetch"):
                continue
            ops.append((op, OpRegistry.get(op.type)))
            if op.type in _RANDOM_OPS and not op.attr("is_test", False):
                uses_rng = True
            for n in op_reads(op):
                if n in produced or n in read_state:
                    continue
                var = block.find_var(n)
                if var is not None and var.persistable:
                    read_state.append(n)
                else:
                    raise RuntimeError(
                        f"op {op.type} reads {n!r} which is neither fed, "
                        "produced by an earlier op, nor persistable")
            for n in op.output_arg_names:
                if not n:
                    continue
                produced.add(n)
                var = block.find_var(n)
                if var is not None and var.persistable and n not in written_state:
                    written_state.append(n)
        for n in fetch_names:
            if n not in produced and n not in read_state:
                var = block.find_var(n)
                if var is not None and var.persistable:
                    read_state.append(n)
                else:
                    raise RuntimeError(f"fetch target {n!r} is never produced")
        # last reader (or, for a value nobody reads, the writer) of each
        # value that is neither persistable, fed nor fetched
        keep = set(feed_vals) | set(fetch_names)
        last = {}
        for i, (op, _) in enumerate(ops):
            for n in op_reads(op) + op.output_arg_names:
                if n and n not in keep:
                    last[n] = i
        release = [[] for _ in ops]
        for n, i in last.items():
            var = block.find_var(n)
            if var is None or not var.persistable:
                release[i].append(n)
        return _Plan([(op, info, tuple(rel))
                      for (op, info), rel in zip(ops, release)],
                     tuple(read_state), tuple(written_state),
                     tuple(fetch_names), uses_rng)
