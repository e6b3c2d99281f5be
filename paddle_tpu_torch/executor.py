"""Executor: interprets a block op by op on torch tensors, and on a CUDA
place replays a captured CUDA graph of the block, the port's counterpart
of the JAX Executor's ``jax.jit``.

Per (program fingerprint, feed signature, fetch names, place, AMP,
trace_ops) it caches a run plan: which persistables the block reads
(the state, taken from the Scope), which it writes back, each op's
registry entry, each value's last reader, the donation plan and whether
the plan can be captured.  Before a plan is built the static verifier
(``analysis/``) runs: the fetch-reachability pass always, and the whole
error tier with ``FLAGS.check_program``; either raises before any kernel
launches.  ``run(..., optimize_program=True)`` first rewrites the program
(``analysis.optimize_program``: constant folding, CSE, dead-code
elimination, each verified or reverted), memoized per (program, feed
names, fetches); the plan cache is keyed on the rewritten program.

Values die young: once the last op that reads a value has run, the run
drops it, unless it is persistable, fed or fetched.  A rematerialization
segment (``recompute_scope``) keeps its values local: at the segment's
end the run drops everything the segment made that no later op, fetch
or state reads, the residuals its ops left under undeclared names too;
the segment's grad op replays the forward from the segment's inputs.

Donation: the state names ``analysis.donation_mask`` proves dead after
their last write are updated in place.  Right after the op that last
writes such a name, the run copies the new value into the tensor the
scope holds (``copy_``) and drops the new one, so the scope's tensor
keeps its storage across steps and at most one parameter's update is
live beside it.  The copy goes only into a tensor this plan bound in
that scope on an earlier run; a tensor the caller bound (which may share
its memory with a numpy array) is replaced at the end of the run, as a
held name always is.  The analysis reasons by name, but ``assign`` hands
back its input and ``reshape`` a view of it, so the run also checks
storage: a name whose old tensor another live value still shares is not
copied that run, and its new tensor is bound at the end.  If the
analysis raises, nothing is donated.

CUDA graphs: on a CUDA place a plan that can be captured is captured on
its second run in a scope (the first run builds the plan and is the
warm-up) and replayed on every run after that.  Whether a plan can be
captured is decided statically at plan build, and the plan records why
not, by op (``_Plan.eager_reasons``): an op that reads device values on
the host or copies host data each run (``OpInfo.host_sync``), a
``while`` or ``conditional_block`` (its host loop reads the condition), a
LoD value or feed, a fetched SparseGrad, a random op (the per-run seed
would freeze), or ``FLAGS.trace_ops`` (host ranges do not replay).  A
plan classified as capturable that fails to capture raises.  Feeds are
copied into the graph's static feed tensors on each replay; a state
tensor the caller re-bound is copied into the static one and the scope
bound back to it; donated state is updated in place inside the graph;
other written state is cloned out after the replay, and so are the
fetches with ``return_numpy=False``.  A replay runs no Python, so the
kernels' launch counters get each counter's change over the capture
added on every replay (``kernels.add_launch_counts``).  One capture at
a time runs on a device, and no other run of an Executor on that device
runs during it (``_DeviceGate``), so the change is the plan's own.
``disable_graphs()`` runs every plan eagerly, the counterpart of
``jax.disable_jit()``.

On a CUDA place every run holds float32 math at float32: TF32 is off for
cuDNN and matmul, and so are bf16 matmuls' reduced-precision
reductions, while any run is in flight (``_f32_math``), so the library
calls that the kernels leave to PyTorch (the stride-2 convs, the mul
backward's products) round like the kernels do, captured or not.

AMP (``paddle_tpu_torch.amp``) is read once per run: the forward ops and
the grad ops of one run see the same state, and the plan cache is keyed
on it, as the JAX Executor's compile cache is.

AOT artifacts (``paddle_tpu_torch.aot``): at a plan-cache miss the
Executor's ``aot_store`` is asked first (``paddle_tpu/executor.py:357-380``); on a manifest match, with the
donation mask proved again (``rejected_donation_drift`` on drift), the
plan is built from the entry's record without the verifier and without
classifying the block again.  Inside ``aot.capture(writer)`` every plan
built is recorded into the writer.  ``compile_counts`` says how each miss
was filled (``plan``: built here; ``aot``: from a store).

Every run records the JAX Executor's seven metric families, with its
names and label keys (``paddle_tpu_torch.observability``), labelled by
``program``, the first 12 hex digits of ``Program.fingerprint()``.  A
plan-cache miss or hit counts with ``source="graph"`` for a plan that
is captured and ``source="plan"`` for one that runs eagerly: the port
builds an op plan where the JAX package traces and compiles; a plan built
from an artifact store counts ``source="aot"``, misses and hits.
``executor_compile_seconds`` holds each plan build and each capture.
Besides the ``executor.compile`` and ``executor.step`` host events, a
capture records ``executor.capture`` (its pool's bytes), and a plan built
for a CUDA place that runs eagerly records ``executor.eager_plan`` (its
first reason).
``executor_step_seconds`` is host dispatch (CUDA runs asynchronously);
``executor_fetch_seconds`` holds the device-to-host sync.
``FLAGS.trace_ops`` runs each op inside
``torch.profiler.record_function(op.type)`` and keys the plan cache.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import amp, analysis, framework, kernels
from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.analysis import optimize as _opt
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import Place, Program, Variable
from paddle_tpu_torch.lod import LoDArray, LoDRankTable, create_lod_array
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability.events import GLOBAL_EVENTS as _EVENTS
from paddle_tpu_torch.ops.common import torch_dtype
from paddle_tpu_torch.ops.io_ops import RANDOM_OPS, segment_op_generator
from paddle_tpu_torch.registry import LowerContext, OpRegistry, host_sync_reason
from paddle_tpu_torch.sparse import SparseGrad
from paddle_tpu_torch.tensor_array import TensorArray


# ---------------------------------------------------------------------------
# Telemetry: the JAX Executor's families (paddle_tpu/executor.py:59-84),
# keyed by program fingerprint so GET /metrics attributes cost per program
# ---------------------------------------------------------------------------

_M_CACHE_MISS = _metrics.counter(
    "executor_compile_cache_miss_total",
    "Executor.run plan-cache misses, by how the plan runs (source=graph: "
    "verified, classified, captured as a CUDA graph on its second run; "
    "source=plan: verified, classified, run op by op; source=aot: built "
    "from an artifact store's record)")
_M_CACHE_HIT = _metrics.counter(
    "executor_compile_cache_hit_total",
    "Executor.run plan-cache hits (cached run plan reused), labeled by "
    "how the plan runs (graph|plan) or where it came from (aot)")
_M_COMPILE_SEC = _metrics.histogram(
    "executor_compile_seconds",
    "wall time per plan build (verify + classify) and per CUDA graph "
    "capture (capture + first replay)",
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


#: Ops whose host loop reads their condition every iteration.
_HOST_LOOP_OPS = frozenset({"while", "conditional_block"})

_graphs_off = [0]
_graphs_off_lock = threading.Lock()


@contextlib.contextmanager
def disable_graphs():
    """Run every plan eagerly, op by op, inside this block (the
    counterpart of ``jax.disable_jit()``): for comparing a graph's
    replays with eager runs, and for stepping through ops."""
    with _graphs_off_lock:
        _graphs_off[0] += 1
    try:
        yield
    finally:
        with _graphs_off_lock:
            _graphs_off[0] -= 1


def graphs_enabled() -> bool:
    return _graphs_off[0] == 0


class _DeviceGate:
    """Runs on one device share the gate; a capture holds it alone, so
    one capture at a time runs on the device, and no other run's kernel
    launches land in the capture's counter change.  A waiting capture
    goes before runs that arrive after it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._runs = 0
        self._capturing = False
        self._waiting = 0

    @contextlib.contextmanager
    def run(self):
        with self._cond:
            while self._capturing or self._waiting:
                self._cond.wait()
            self._runs += 1
        try:
            yield
        finally:
            with self._cond:
                self._runs -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def capture(self):
        with self._cond:
            self._waiting += 1
            while self._capturing or self._runs:
                self._cond.wait()
            self._waiting -= 1
            self._capturing = True
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._cond.notify_all()


_gates: Dict[Any, _DeviceGate] = {}
_gates_lock = threading.Lock()

def _gate(device) -> _DeviceGate:
    with _gates_lock:
        return _gates.setdefault(device, _DeviceGate())


class _Segment:
    """One rematerialization segment of a plan: its first and last op,
    its id (which names its key) and the values it hands on."""

    __slots__ = ("start", "end", "seg_id", "exports")

    def __init__(self, start, end, seg_id, exports):
        self.start, self.end = start, end
        self.seg_id = seg_id
        self.exports = exports


class _Graph:
    """A plan captured in one scope: the graph, its static feeds, the
    state tensors it reads, its fetches and written state (in its pool),
    and each launch counter's change over one run."""

    __slots__ = ("graph", "feeds", "state", "fetches", "written",
                 "launches", "pool_bytes")

    def __init__(self, graph, feeds, state, fetches, written, launches,
                 pool_bytes):
        self.graph = graph
        self.feeds = feeds
        self.state = state
        self.fetches = fetches
        self.written = written
        self.launches = launches
        self.pool_bytes = pool_bytes


class _ScopeRuns:
    """What a plan keeps per scope: its runs there, the state tensors it
    bound there (donation copies only into those) and its graph."""

    __slots__ = ("runs", "bound", "graph")

    def __init__(self):
        self.runs = 0
        self.bound: Dict[str, torch.Tensor] = {}
        self.graph: Optional[_Graph] = None


class _Plan:
    """A classified block: the state it reads, the persistables it
    writes, each op with its registry entry and the values to drop once
    it has run, the donated names and the op after which each is copied
    into the scope's tensor, the recompute segments, and why the plan
    cannot be captured (empty: it can)."""

    __slots__ = ("ops", "state_names", "written_names", "fetch_names",
                 "uses_rng", "donated", "donate_after", "donation",
                 "segments", "eager_reasons", "scopes", "source")

    def __init__(self, ops, state_names, written_names, fetch_names,
                 uses_rng, donated=(), donate_after=None, donation=None,
                 segments=(), eager_reasons=(), source="plan"):
        self.ops = ops    # [(op, OpInfo, names to release after it)]
        self.state_names = state_names
        self.written_names = written_names
        self.fetch_names = fetch_names
        self.uses_rng = uses_rng
        self.donated = donated
        self.donate_after = donate_after or {}
        self.donation = donation or {}
        self.segments = segments
        self.eager_reasons = eager_reasons
        self.scopes = weakref.WeakKeyDictionary()   # Scope -> _ScopeRuns
        self.source = source   # "plan": built here; "aot": from a store

    @property
    def capturable(self) -> bool:
        return not self.eager_reasons

    def scope_runs(self, scope) -> _ScopeRuns:
        runs = self.scopes.get(scope)
        if runs is None:
            runs = self.scopes[scope] = _ScopeRuns()
        return runs


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
    from the enclosing scope (``dataflow.sub_block_external_reads``,
    less the sub-blocks' own variables, which the op sets itself: a
    step input, a memory)."""
    names = [n for n in op.input_arg_names if n]
    extra = dataflow.sub_block_external_reads(op).difference(names)
    return names + sorted(n for n in extra
                          if op.block.find_var(n) is not None)


def _op_sync_reason(op, info) -> Optional[str]:
    """Why ``op`` itself cannot run inside a captured graph, or None."""
    if op.type in RANDOM_OPS and not op.attr("is_test", False):
        return "a random op: its per-run seed would freeze at capture"
    if op.type in _HOST_LOOP_OPS:
        return "its host loop reads its condition"
    return host_sync_reason(info, op)


def _eager_reasons(block, ops, feed_vals, fetch_names, trace_ops
                   ) -> Tuple[Tuple[str, str], ...]:
    """Why a plan of ``ops`` cannot be captured, as (where, why) pairs:
    "op 12 (multiclass_nms)" or "feed x" or "FLAGS.trace_ops"."""
    reasons: List[Tuple[str, str]] = []
    if trace_ops:
        reasons.append(("FLAGS.trace_ops",
                        "host ranges (record_function) do not replay"))
    for name, v in sorted(feed_vals.items()):
        if isinstance(v, (LoDArray, SparseGrad)):
            reasons.append((f"feed {name}", "a LoD or SparseGrad feed"))
    sparse_grads = {n + "@GRAD" for op in block.ops
                    if op.type == "lookup_table" and op.attr("is_sparse")
                    for n in op.input("W")}
    for name in fetch_names:
        if name in sparse_grads:
            reasons.append((f"fetch {name}", "a SparseGrad fetch"))
    for i, (op, info) in enumerate(ops):
        why = _op_sync_reason(op, info)
        for _k, sub in (dataflow.op_sub_blocks(op) if why is None else ()):
            for _b, _j, sub_op in dataflow.walk_ops(sub):
                sub_why = _op_sync_reason(sub_op, OpRegistry.get(sub_op.type))
                if sub_why is not None:
                    why = f"its sub-block's {sub_op.type}: {sub_why}"
                    break
            if why is not None:
                break
        if why is None:
            lod = [n for n in op.input_arg_names + op.output_arg_names
                   if n and getattr(block.find_var(n), "lod_level", 0)]
            if lod:
                why = (f"reads or writes the LoD value {lod[0]!r}, whose "
                       "offsets size its outputs")
        if why is not None:
            reasons.append((f"op {i} ({op.type})", why))
    return tuple(reasons)


class Executor:
    """Op-by-op executor on one place, whose plans are captured as CUDA
    graphs and replayed on a CUDA place: ``CUDAPlace(0)`` unless the
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
        self._opt_cache: Dict[Any, Any] = {}  # key -> (program, OptReport)
        self._lock = threading.Lock()
        self._step = 0
        # the artifact store consulted at plan misses (paddle_tpu_torch/
        # aot), if any
        self.aot_store = None
        # how each plan miss was filled (serving labels a replica's boot
        # by it: plan / aot / mixed)
        self.compile_counts = {"plan": 0, "aot": 0}

    # -- public api ---------------------------------------------------------

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        optimize_program: bool = False,
    ):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = tuple(
            v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or []))
        if optimize_program:
            # rewrite ahead of the plan cache: the OPTIMIZED program's
            # fingerprint keys the cache
            program = self._optimized(program, feed, fetch_names)
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
        if not cache_hit:
            t_plan = time.perf_counter()
            with _EVENTS.span("executor.compile", program=prog_label):
                # the artifact store gets first refusal
                plan = self._aot_lookup(program, fp, feed_vals, fetch_names,
                                        trace_ops)
                if plan is None:
                    self._verify(program, feed_vals, fetch_names)
                    plan = self._classify(program, feed_vals, fetch_names,
                                          trace_ops)
                    self._aot_export(fp, feed_vals, plan)
            self.compile_counts[plan.source] += 1
            self._cache[key] = plan
            if self.device.type == "cuda" and plan.eager_reasons:
                where, why = plan.eager_reasons[0]
                _EVENTS.instant("executor.eager_plan", program=prog_label,
                                where=where, why=why)
            if plan.donation:
                _opt.set_donation_gauge(prog_label, plan.donation)
            _M_COMPILE_SEC.observe(time.perf_counter() - t_plan,
                                   program=prog_label)
        graphed = (self.device.type == "cuda" and plan.capturable
                   and graphs_enabled())
        source = ("aot" if plan.source == "aot"
                  else "graph" if graphed else "plan")
        if cache_hit:
            _M_CACHE_HIT.inc(program=prog_label, source=source)
        else:
            _M_CACHE_MISS.inc(program=prog_label, source=source)

        state = {}
        missing = []
        for n in plan.state_names:
            v = scope.get(n)
            if v is None:
                missing.append(n)
            state[n] = v
        if missing:
            raise RuntimeError(
                f"persistable variables not initialized in scope: {missing}; "
                "run the startup program first")

        runs = plan.scope_runs(scope)
        tag = "hit" if cache_hit else "miss"
        ev_t0 = _EVENTS.now()
        t_step = time.perf_counter()
        if graphed and runs.graph is not None and not self._restage(
                plan, runs, scope, state, feed_vals):
            runs.graph = None
            runs.runs = 0    # the state changed shape: warm up again
        if graphed and runs.graph is not None:
            fetches = self._replay(plan, runs, scope, feed_vals,
                                   return_numpy)
        elif graphed and runs.runs >= 1:
            ev_cap = _EVENTS.now()
            t_cap = time.perf_counter()
            self._capture(plan, runs, scope, state, feed_vals, amp_on,
                          prog_label)
            dt_cap = time.perf_counter() - t_cap
            _M_COMPILE_SEC.observe(dt_cap, program=prog_label)
            _EVENTS.complete("executor.capture", ev_cap, dt_cap,
                             program=prog_label,
                             pool_bytes=runs.graph.pool_bytes)
            fetches = self._replay(plan, runs, scope, feed_vals,
                                   return_numpy, launched=True)
        else:
            fetches = self._run_eager(plan, runs, scope, state, feed_vals,
                                      program, amp_on, trace_ops)
        runs.runs += 1
        dt_step = time.perf_counter() - t_step
        _M_STEP_SEC.observe(dt_step, program=prog_label, cached=tag)
        _EVENTS.complete("executor.step", ev_t0, dt_step,
                         program=prog_label, cached=tag)
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

    def optimize_report(self, program: Program, feed: Dict[str, Any],
                        fetch_names: Sequence[str]):
        """The OptReport from a prior run(optimize_program=True) with the
        same (program, feed names, fetches); None before any such run."""
        key = (program.cache_key(), tuple(sorted(feed)), tuple(fetch_names))
        hit = self._opt_cache.get(key)
        return hit[1] if hit is not None else None

    def graph_stats(self) -> Dict[str, Any]:
        """The CUDA graphs this Executor holds; their pools' bytes (as the
        caching allocator reserved them over each capture) and the bytes
        of the tensors they keep allocated (static feeds, fetches and
        written state; the scope holds the rest); the plans that run
        eagerly with the first reason of each."""
        graphs = [r.graph for p in self._cache.values()
                  for r in list(p.scopes.values()) if r.graph is not None]

        def held(g):
            ts = (list(g.feeds.values()) + list(g.fetches)
                  + list(g.written.values()))
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))

        return {"graphs": len(graphs),
                "pool_bytes": sum(g.pool_bytes for g in graphs),
                "static_bytes": sum(held(g) for g in graphs),
                "eager_plans": [p.eager_reasons[0]
                                for p in self._cache.values()
                                if p.eager_reasons]}

    def build_callable(self, program: Program, feed_vals: Dict[str, Any],
                       fetch_names: Sequence[str],
                       scope: Optional[Scope] = None):
        """``(fn, state, feeds, uses_rng)``: a pure ``fn(state, feeds[,
        seed]) -> (fetches, new_state)`` on tensors, the current state
        from ``scope`` and the feeds converted to this Executor's device
        (``paddle_tpu/executor.py:655-671``).  ``fn`` writes nothing to
        the scope and donates nothing; ``new_state`` holds the read and
        the written state names, so it chains as the next call's state.
        On the card ``fn`` can be captured in a ``torch.cuda.graph``
        where its plan can (``_Plan.eager_reasons``)."""
        scope = scope or global_scope()
        block = program.global_block()
        feeds = {name: _convert_feed(v, block.find_var(name), self.device)
                 for name, v in feed_vals.items()}
        fetch_names = tuple(fetch_names)
        self._verify(program, feeds, fetch_names)
        plan = self._classify(program, feeds, fetch_names, donate=False)
        state = {n: scope.get(n) for n in plan.state_names}
        missing = [n for n, v in state.items() if v is None]
        if missing:
            raise RuntimeError(f"uninitialized persistables: {missing}")
        out_state = tuple(dict.fromkeys(plan.state_names
                                        + plan.written_names))
        amp_on = amp.is_enabled()
        device = self.device

        def fn(state, feeds, seed=None):
            values: Dict[str, Any] = dict(state)
            values.update(feeds)
            generator = None
            if plan.uses_rng:
                generator = torch.Generator(device=device).manual_seed(
                    int(seed or 0))
            with torch.no_grad(), _math(device), amp.amp_guard(amp_on):
                _run_ops(plan, values, device, generator)
            return ([values[n] for n in plan.fetch_names],
                    {n: values[n] for n in out_state})

        return fn, state, feeds, plan.uses_rng

    # -- internals ----------------------------------------------------------

    def _optimized(self, program: Program, feed: Dict[str, Any],
                   fetch_names: Sequence[str]) -> Program:
        """Memoized rewrite pipeline for run(optimize_program=True); a
        program the verifier rejects comes back unchanged."""
        key = (program.cache_key(), tuple(sorted(feed)), tuple(fetch_names))
        hit = self._opt_cache.get(key)
        if hit is None:
            hit = _opt.optimize_program(
                program, feed_names=set(feed), fetch_names=fetch_names)
            self._opt_cache[key] = hit
        return hit[0]

    @staticmethod
    def _verify(program: Program, feed_vals: Dict[str, Any],
                fetch_names: Sequence[str]):
        """The static checks of a plan miss (``paddle_tpu/executor.py:
        478-499``): with ``check_program`` the whole error tier, else the
        fetch-reachability pass, which names a fetch nothing writes."""
        if FLAGS.get("check_program"):
            analysis.check_or_raise(
                program, feed_names=set(feed_vals), fetch_names=fetch_names,
                header="program rejected before compile "
                       "(flag check_program=1)")
            return
        diags = analysis.verify_program(
            program, feed_names=set(feed_vals), fetch_names=fetch_names,
            only=("fetch-reachability",))
        if diags:
            raise RuntimeError(
                "; ".join(d.message for d in diags)
                + " — run with flags check_program=1 for full program "
                  "verification")

    def _generator(self, program: Program):
        with self._lock:
            self._step += 1
            step = self._step
        seed = (program.seed or 0) * 1000003 + step
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run_eager(self, plan, runs, scope, state, feed_vals, program,
                   amp_on, trace_ops):
        values: Dict[str, Any] = dict(state)
        values.update(feed_vals)
        generator = self._generator(program) if plan.uses_rng else None
        # donation copies only into tensors this plan bound in the scope
        owned = {n: state[n] for n in plan.donated
                 if runs.bound.get(n) is state[n]}
        gate = (_gate(self.device).run() if self.device.type == "cuda"
                else contextlib.nullcontext())
        with gate, torch.no_grad(), _math(self.device), \
                amp.amp_guard(amp_on):
            _run_ops(plan, values, self.device, generator, owned, trace_ops)
        for n in plan.written_names:
            v = values[n]
            scope.set(n, v)
            if n in plan.donated:
                runs.bound[n] = v
        return [values[n] for n in plan.fetch_names]

    def _restage(self, plan, runs, scope, state, feed_vals) -> bool:
        """Bring the graph's static inputs up to date before a replay:
        the feeds into its feed tensors, a state tensor the caller bound
        anew into its state tensor (the scope is bound back to it).
        False where a shape or dtype no longer matches the capture."""
        g = runs.graph
        for n, static in g.state.items():
            t = state[n]
            if t is static:
                continue
            if not (isinstance(t, torch.Tensor) and t.shape == static.shape
                    and t.dtype == static.dtype):
                return False
            static.copy_(t)
            scope.set(n, static)
        for n, static in g.feeds.items():
            v = feed_vals[n]
            if v.shape != static.shape or v.dtype != static.dtype:
                return False
            static.copy_(v)
        return True

    def _capture(self, plan, runs, scope, state, feed_vals, amp_on,
                 prog_label):
        """Capture the plan in a CUDA graph (the run's second in this
        scope; the first was its warm-up).  Raises if the capture fails:
        a plan classified as capturable never goes on quietly eager."""
        # the graph's own feed tensors: a caller's tensor is never written
        feeds = {n: v.clone() for n, v in feed_vals.items()}
        values: Dict[str, Any] = dict(state)
        values.update(feeds)
        owned = {n: state[n] for n in plan.donated
                 if runs.bound.get(n) is state[n]}
        graph = torch.cuda.CUDAGraph()
        with _gate(self.device).capture(), torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            before = kernels.launch_counts()
            try:
                with torch.no_grad(), _math(self.device), \
                        amp.amp_guard(amp_on), torch.cuda.graph(
                            graph, capture_error_mode="thread_local"):
                    copied = _run_ops(plan, values, self.device, None,
                                      owned)
            except Exception as exc:
                raise RuntimeError(
                    f"CUDA graph capture of program {prog_label} failed; the "
                    "plan was classified as capturable, so an op reads the "
                    "host or syncs without its OpInfo.host_sync mark: "
                    f"{type(exc).__name__}: {exc}") from exc
            after = kernels.launch_counts()
            pool = torch.cuda.memory_reserved(self.device) - reserved
        delta = {k: after[k] - before.get(k, 0) for k in after}
        written = {n: values[n] for n in plan.written_names
                   if n not in copied}
        runs.graph = _Graph(graph, feeds, dict(state),
                            [values[n] for n in plan.fetch_names], written,
                            delta, max(pool, 0))
        for n in copied:
            runs.bound[n] = state[n]

    def _replay(self, plan, runs, scope, feed_vals, return_numpy,
                launched=False):
        """One replay of the scope's graph; ``launched``: the capture
        just counted this run's launches."""
        g = runs.graph
        with _gate(self.device).run():
            g.graph.replay()
            if not launched:
                kernels.add_launch_counts(g.launches)
            for n, v in g.written.items():
                v = v.clone()
                scope.set(n, v)
                if n in plan.donated:
                    runs.bound[n] = v
            fetches = (g.fetches if return_numpy
                       else [v.clone() for v in g.fetches])
        return fetches

    @staticmethod
    def _classify(program: Program, feed_vals: Dict[str, Any],
                  fetch_names: Sequence[str], trace_ops: bool = False,
                  donate: bool = True, record: Optional[dict] = None,
                  donation: Optional[Dict[str, Any]] = None) -> _Plan:
        """Persistables an op reads before any op writes them come from
        the scope; every other input must be fed or produced earlier.
        Then the release plan, the recompute segments, the donation plan
        and whether the plan can be captured.  With an artifact entry's
        ``record`` (and the ``donation`` mask proved for it) the state,
        the written names, the random ops and the eager reasons are the
        record's: the block is not walked for them."""
        block = program.global_block()
        read_state: List[str] = []
        written_state: List[str] = []
        produced: set = set(feed_vals)
        uses_rng = False
        ops = []
        if record is not None:
            ops = [(op, OpRegistry.get(op.type)) for op in block.ops
                   if op.type not in ("feed", "fetch")]
            read_state = list(record["state_names"])
            written_state = list(record["written_names"])
            uses_rng = bool(record["uses_rng"])
        for op in block.ops if record is None else ():
            if op.type in ("feed", "fetch"):
                continue
            ops.append((op, OpRegistry.get(op.type)))
            if op.type in RANDOM_OPS and not op.attr("is_test", False):
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
        for n in fetch_names if record is None else ():
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

        # recompute segments: runs of consecutive ops with one
        # __recompute_seg__; each hands on only what a later op, a fetch
        # or the state reads (``paddle_tpu/executor.py:801-824``)
        segments: List[_Segment] = []
        for i, (op, _) in enumerate(ops):
            seg = op.attr("__recompute_seg__", None)
            if seg is None:
                continue
            if segments and segments[-1].seg_id == seg \
                    and segments[-1].end == i - 1:
                segments[-1].end = i
            else:
                segments.append(_Segment(i, i, seg, None))
        suffix = set(fetch_names) | set(written_state)
        seg_at = {s.end: s for s in segments}
        for i in range(len(ops) - 1, -1, -1):
            s = seg_at.get(i)
            if s is not None:
                written = {n for o, _ in ops[s.start:s.end + 1]
                           for n in o.output_arg_names if n}
                s.exports = frozenset(written & suffix)
            suffix.update(op_reads(ops[i][0]))

        # donation (``paddle_tpu/executor.py:740-765``): the names the
        # analysis proves dead after their last write; nothing if it
        # raises
        donated: Tuple[str, ...] = ()
        donate_after: Dict[int, Tuple[str, ...]] = {}
        if donation is None:
            donation = {}
            if donate and read_state:
                try:
                    donation = _opt.donation_mask(program, set(feed_vals),
                                                  fetch_names)
                except Exception:
                    donation = {}
        if donate and read_state:
            donated = tuple(n for n in read_state
                            if n in donation and donation[n].eligible)
            last_write: Dict[str, int] = {}
            for i, (op, _) in enumerate(ops):
                for n in op.output_arg_names:
                    if n in donated:
                        last_write[n] = i
            for n in donated:
                donate_after.setdefault(last_write[n], ())
                donate_after[last_write[n]] += (n,)

        if record is None:
            reasons = _eager_reasons(block, ops, feed_vals, fetch_names,
                                     trace_ops)
        else:
            reasons = tuple(tuple(r) for r in record["eager_reasons"])
        return _Plan([(op, info, tuple(rel))
                      for (op, info), rel in zip(ops, release)],
                     tuple(read_state), tuple(written_state),
                     tuple(fetch_names), uses_rng, donated, donate_after,
                     donation, tuple(segments), reasons,
                     "plan" if record is None else "aot")


    # -- AOT artifacts (paddle_tpu_torch/aot) --------------------------------

    def _aot_lookup(self, program, fp, feed_vals, fetch_names, trace_ops):
        """The plan of ``aot_store``'s matching entry (source "aot"), or
        None."""
        store = self.aot_store
        if store is None:
            return None
        from paddle_tpu_torch.aot import artifact as _art

        proved = {}

        def _validate(meta):
            state = tuple(meta["state_names"])
            try:
                donation = (_opt.donation_mask(program, set(feed_vals),
                                               fetch_names) if state else {})
            except Exception:
                donation = {}
            have = tuple(n for n in state
                         if n in donation and donation[n].eligible)
            expect = tuple(meta.get("donated_names", ()))
            if have != expect:
                return (f"donation_drift: the manifest donates {expect}, "
                        f"the analysis proves {have}")
            proved["donation"] = donation
            return None

        hit = store.lookup(fp, _art.sig_json(_feed_signature(feed_vals)),
                           fetch_names, validate=_validate)
        if hit is None:
            return None
        return self._classify(program, feed_vals, fetch_names, trace_ops,
                              record=hit[1], donation=proved["donation"])

    @staticmethod
    def _aot_export(fp, feed_vals, plan) -> None:
        """Record ``plan`` into the active ``aot.capture`` writer, if
        any."""
        mod = sys.modules.get("paddle_tpu_torch.aot")
        writer = mod.active_exporter() if mod is not None else None
        if writer is None:
            return
        writer.add(
            program_fp=fp, feed_sig=_feed_signature(feed_vals),
            fetch_names=plan.fetch_names, state_names=plan.state_names,
            donated_names=plan.donated,
            held_names=tuple(n for n in plan.state_names
                             if n not in plan.donated),
            out_state_names=tuple(dict.fromkeys(plan.state_names
                                                + plan.written_names)),
            written_names=plan.written_names, uses_rng=plan.uses_rng,
            eager_reasons=plan.eager_reasons)


def _math(device):
    return (_f32_math() if device.type == "cuda"
            else contextlib.nullcontext())


def _storage(v) -> Optional[int]:
    """The address of the storage under a tensor (a LoD value's data), or
    None for anything else and for an empty storage."""
    if isinstance(v, LoDArray):
        v = v.data
    if not isinstance(v, torch.Tensor):
        return None
    return v.untyped_storage().data_ptr() or None


def _run_ops(plan: _Plan, values: Dict[str, Any], device, generator,
             owned: Optional[Dict[str, torch.Tensor]] = None,
             trace_ops: bool = False) -> set:
    """Run the plan's ops on ``values``: each op, then the values it is
    the last reader of dropped, then the donated names it last wrote
    copied into their scope tensors (``owned``), and at a recompute
    segment's end everything the segment made that it does not hand
    on.  Returns the names copied in place.

    ``donation_mask`` proves by name that nothing reads a donated name
    after its last write, but ops such as ``assign`` or ``reshape`` hand
    back their input or a view of it, so another live name may share the
    old tensor's storage.  Every value the run holds or makes is checked
    against the donated tensors' storage, and a name whose old tensor
    another live value still shares is not copied: its new tensor is
    bound at the end of the run, as a held name's is."""
    seg_start = {s.start: s for s in plan.segments}
    seg_end = {s.end: s for s in plan.segments}
    seg_keys = None
    seg_key = None
    watch: Dict[int, str] = {}     # a donated tensor's storage -> its name
    aliases: Dict[str, list] = {}  # donated name -> [(name, value)] sharing it

    def note(name, v):
        m = watch.get(_storage(v))
        if m is not None and (name != m or v is not owned[m]):
            aliases.setdefault(m, []).append((name, v))

    for n, t in (owned or {}).items():
        p = _storage(t)
        if p in watch:    # two donated names on one storage: neither copies
            aliases.setdefault(watch[p], []).append((n, t))
            aliases.setdefault(n, []).append((watch[p], owned[watch[p]]))
        elif p is not None:
            watch[p] = n
    if watch:
        for n, v in values.items():
            note(n, v)
    copied = set()
    for i, (op, info, release) in enumerate(plan.ops):
        gen = generator
        s = seg_start.get(i)
        if s is not None:
            seg_keys = set(values)
            seg_key = values.get(f"__segkey_{s.seg_id}__")
        if seg_keys is not None and generator is not None:
            gen = segment_op_generator(seg_key, op, device, generator)
        ctx = LowerContext(op, values, device, gen)
        if trace_ops:
            with torch.profiler.record_function(op.type):
                info.lower(ctx)
        else:
            info.lower(ctx)
        for n in release:
            values.pop(n, None)
        if watch:
            for n in op.output_arg_names:
                if n:
                    note(n, values.get(n))
            for n in plan.donate_after.get(i, ()):
                old = owned.get(n)
                new = values[n]
                if old is None or new is old or any(
                        values.get(k) is v for k, v in aliases.get(n, ())):
                    continue
                if (isinstance(new, torch.Tensor) and new.shape == old.shape
                        and new.dtype == old.dtype
                        and new.device == old.device):
                    old.copy_(new)
                    values[n] = old
                    copied.add(n)
        s = seg_end.get(i)
        if s is not None:
            for n in set(values) - seg_keys - s.exports:
                values.pop(n)
            seg_keys = seg_key = None
    return copied
