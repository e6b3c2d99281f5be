"""Whole-program optimizer: parity-gated rewrite passes over Program
(the port of ``paddle_tpu/analysis/optimize.py``).

Every pass here *transforms* a Program using the same dataflow facts
the verifier checks (liveness, use-def webs from
``analysis/dataflow.py``), under a hard safety contract:

- passes run on a clone, never the caller's program;
- the pipeline refuses to optimize a program the verifier already
  rejects (garbage in stays garbage — unoptimized);
- after every pass the error-tier verifier re-runs on the output; any
  new error reverts that pass and records a PVO02 diagnostic;
- the differential harness (``check_parity``) executes
  optimized-vs-original programs and demands bit-identical fetches.

Rewrite passes (in pipeline order, iterated to a fixpoint):

  constant-fold   ops whose inputs are all statically-known constants
                  are evaluated on CPU tensors through the port's own
                  registry and replaced by a ``fill`` op carrying the
                  computed value (dtype preserved exactly)
  cse             common-subexpression elimination keyed by (op type,
                  inputs-at-version, attrs); global block only —
                  sub-blocks run under their own control flow and
                  must never be merged across
  dce             dead-op/dead-var elimination: the executable version
                  of the verifier's PVI01/PVI02 findings (backward
                  liveness from fetches + persistable state + side
                  effects)

``backward_slice`` is the fetch-driven slicer behind ``Program.prune``,
and ``donation_mask`` is the donation-safety analyzer: a static proof,
per executor state input, that updating its tensor in place cannot be
observed (no top-level read after its last write, not aliased into a
control-flow sub-block, actually overwritten).  The Executor copies the
new value of each such name into the scope's tensor right after the op
that writes it, and holds every other state name.

Optimizer diagnostic codes (PVO*, stable — see analysis/passes.py for
the verifier's PVE/PVW/PVI tables):

  PVO01  optimizer skipped: input program already fails verification
  PVO02  pass output failed verification; pass reverted
  PVO03  dce/slice skipped: fetch set unknown
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from paddle_tpu_torch.framework import Operator, Program
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.ops.io_ops import RANDOM_OPS
from paddle_tpu_torch.registry import LowerContext, OpRegistry
from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.analysis.verify import (
    Diagnostic,
    Severity,
    verify_program,
)

_M_OPS_REMOVED = _metrics.counter(
    "optimizer_ops_removed_total",
    "ops removed/replaced by optimizer rewrite passes, labeled by pass")
_M_DONATION = _metrics.gauge(
    "optimizer_donation_eligible",
    "state inputs the donation-safety analyzer proved donatable for the "
    "most recently planned program")

# The Executor's random ops and ``segment_rng_key``, which draws a
# segment's key.  Random ops draw from the step's generator *in program
# order* — removing or merging one would shift the stream of every later
# random op, so no rewrite pass touches them.
_RANDOM_OPS = RANDOM_OPS | {"segment_rng_key"}

# Zero-input op types safe to evaluate at optimize time.  ``load`` is
# excluded on purpose: it reads a file the deploy host may not share.
_CONST_SOURCE_OPS = frozenset({"fill", "fill_constant"})

# Folded results above this many elements would bloat the serialized
# program (fill embeds the data inline); leave big tensors to the run.
_FOLD_SIZE_CAP = 65536


# ---------------------------------------------------------------------------
# Backward slicing (subsumes Program.prune)
# ---------------------------------------------------------------------------


def backward_slice(program: Program, targets: Sequence[str],
                   keep_side_effects: bool = False) -> Program:
    """Fetch-driven backward slice: clone the program keeping only ops
    whose outputs (transitively) feed a target.  ``feed`` ops are
    always kept (the executor skips them but exports carry them); a
    kept control-flow op pulls in everything its sub-blocks read from
    the enclosing scope.

    ``keep_side_effects=False`` reproduces the historical
    ``Program.prune`` contract (inference export: unrelated print/save
    ops are dropped); ``True`` is the DCE posture — side-effecting ops
    survive even when no target depends on them.
    """
    needed: Set[str] = set(
        t.name if hasattr(t, "name") else str(t) for t in targets)
    p = program.clone()
    block = p.global_block()
    kept: List[Operator] = []
    for op in reversed(block.ops):
        keep = (bool(needed & set(op.output_arg_names))
                or op.type == "feed"
                or (keep_side_effects
                    and (dataflow.op_has_side_effects(op)
                         or op.type in dataflow.PSEUDO_OPS)))
        if keep:
            kept.append(op)
            needed |= dataflow.effective_reads(op)
    block.ops = list(reversed(kept))
    p._version = getattr(p, "_version", 0) + 1
    p.invalidate_cache()
    return p


# ---------------------------------------------------------------------------
# Pass: dead-op / dead-var elimination
# ---------------------------------------------------------------------------


def _sub_block_keeps(op: Operator) -> bool:
    """A control-flow op must survive DCE when anything *inside* it has
    an effect the fetch-liveness walk cannot see: a side-effecting op,
    a random op (key-stream order), or a write to persistable state."""
    for _, sub in dataflow.op_sub_blocks(op):
        for _b, _i, sub_op in dataflow.walk_ops(sub):
            if (dataflow.op_has_side_effects(sub_op)
                    or sub_op.type in _RANDOM_OPS):
                return True
            for n in dataflow.op_writes(sub_op):
                var = sub.find_var(n)
                if var is not None and var.persistable:
                    return True
    return False


def dead_code_elimination(program: Program, feeds: Optional[Set[str]],
                          fetches: Sequence[str]) -> Tuple[int, int]:
    """Remove ops whose results cannot reach a fetch, persistable
    state, or a side effect (the executable form of PVI01), then drop
    variable declarations nothing references anymore (PVI02).  Mutates
    ``program`` in place; returns (ops_removed, vars_removed)."""
    block = program.global_block()
    live: Set[str] = set(fetches)
    kept: List[Operator] = []
    removed = 0
    for op in reversed(block.ops):
        writes = dataflow.op_writes(op)
        keep = (op.type in dataflow.PSEUDO_OPS
                or op.type in _RANDOM_OPS
                or dataflow.op_has_side_effects(op)
                or any(n in live for n in writes))
        if not keep:
            for n in writes:
                var = block.find_var(n)
                if var is not None and var.persistable:
                    keep = True
                    break
        if not keep and any(True for _ in dataflow.op_sub_blocks(op)):
            keep = _sub_block_keeps(op)
        if keep:
            kept.append(op)
            live |= dataflow.effective_reads(op)
        else:
            removed += 1
    block.ops = list(reversed(kept))

    # dead declarations: never referenced by a surviving op, not state,
    # not part of the feed/fetch surface.  With the feed set unknown
    # (lint mode), every producer-less var counts as the input surface.
    referenced: Set[str] = set(fetches)
    if feeds is None:
        referenced |= dataflow.implicit_feed_vars(program)
    else:
        referenced |= set(feeds)
        referenced |= {f + "@len" for f in feeds}
    for _b, _i, op in dataflow.walk_ops(block):
        referenced.update(dataflow.op_reads(op))
        referenced.update(dataflow.op_writes(op))
        referenced.update(dataflow.sub_block_bound_names(op))
    vars_removed = 0
    for blk in program.blocks:
        dead = [n for n, v in blk.vars.items()
                if n not in referenced and not v.persistable]
        for n in dead:
            del blk.vars[n]
            vars_removed += 1
    if removed or vars_removed:
        program._version = getattr(program, "_version", 0) + 1
        program.invalidate_cache()
    return removed, vars_removed


# ---------------------------------------------------------------------------
# Pass: constant folding
# ---------------------------------------------------------------------------


def _writes_persistable(op: Operator, block) -> bool:
    for n in dataflow.op_writes(op):
        var = block.find_var(n)
        if var is not None and var.persistable:
            return True
    return False


def _eval_const_op(op: Operator, consts: Dict[str, Any]):
    """Evaluate one op on CPU tensors over concrete inputs, through the
    port's registry (the JAX package evaluates it with ``jnp``).
    Returns the single output value as numpy, or None when evaluation is
    not possible/meaningful (any exception => not foldable)."""
    import torch

    from paddle_tpu_torch.executor import _to_numpy, tensor_from_numpy

    info = OpRegistry.get(op.type, none_ok=True)
    if info is None:
        return None
    cpu = torch.device("cpu")
    values = {n: tensor_from_numpy(consts[n], cpu)
              for n in dataflow.op_reads(op)}
    try:
        with torch.no_grad():
            info.lower(LowerContext(op, values, cpu, None))
    except Exception:
        return None
    out_names = dataflow.op_writes(op)
    result = values.get(out_names[0])
    if result is None or not isinstance(result, torch.Tensor):
        return None  # LoDArray / SparseGrad / host objects: skip
    if result.numel() > _FOLD_SIZE_CAP:
        return None
    return _to_numpy(result)


def constant_fold(program: Program, feeds: Optional[Set[str]]) -> int:
    """Replace pure ops whose inputs are all statically-known constants
    with ``fill`` ops carrying the computed value (dtype preserved from
    the actual computation).  Constants originate from zero-input
    ``fill``/``fill_constant`` ops and propagate forward; persistable
    writes are never folded (startup initializers must keep running —
    their values ARE the mutable state).  Mutates in place; returns the
    number of ops folded."""
    from paddle_tpu_torch import amp

    if amp.is_enabled():
        # amp rewrites lowering dtypes at run time; a fold here would
        # bake full-precision values into a half-precision program
        return 0
    block = program.global_block()
    consts: Dict[str, Any] = {}
    folds = 0
    for idx, op in enumerate(block.ops):
        reads = dataflow.op_reads(op)
        writes = dataflow.op_writes(op)
        foldable = (
            op.type not in dataflow.PSEUDO_OPS
            and op.type not in _RANDOM_OPS
            and not dataflow.op_has_side_effects(op)
            and not any(True for _ in dataflow.op_sub_blocks(op))
            and op.attr("__recompute_seg__") is None
            and len(writes) == 1
            and not _writes_persistable(op, block)
            and (all(n in consts for n in reads) if reads
                 else op.type in _CONST_SOURCE_OPS)
        )
        value = _eval_const_op(op, consts) if foldable else None
        if value is None:
            for n in writes:  # overwrite kills the known-constant fact
                consts.pop(n, None)
            continue
        consts[writes[0]] = value
        if op.type in _CONST_SOURCE_OPS:
            continue  # already a constant op; nothing to rewrite
        block.ops[idx] = Operator(
            block, "fill",
            inputs={},
            outputs={"Out": [writes[0]]},
            attrs={"shape": [int(s) for s in value.shape],
                   "dtype": str(value.dtype),
                   "data": value},
        )
        folds += 1
    if folds:
        program._version = getattr(program, "_version", 0) + 1
        program.invalidate_cache()
    return folds


# ---------------------------------------------------------------------------
# Pass: common-subexpression elimination
# ---------------------------------------------------------------------------


def _canonical_attrs(op: Operator) -> Optional[str]:
    """Stable attr serialization for CSE keys; None = not hashable
    (Block-valued attrs never get here — sub-block ops are skipped)."""
    try:
        return json.dumps(
            {k: v for k, v in op.attrs.items()},
            sort_keys=True, default=_attr_token)
    except Exception:
        return None


def _attr_token(v):
    if isinstance(v, np.ndarray):
        return ("__ndarray__", str(v.dtype), v.shape, v.tobytes().hex())
    return str(v)


def common_subexpression_elimination(program: Program,
                                     fetches: Sequence[str]) -> int:
    """Merge ops computing the same value: identical (type, inputs at
    their current def-version, attrs).  Global block only — an op in a
    ``while``/``recurrent`` sub-block runs under different control flow
    each iteration, so cross-block merging is forbidden by construction
    (pinned by tests/test_torch_optimize.py).  Mutates in place; returns the
    number of ops merged away."""
    block = program.global_block()
    web = dataflow.UseDefWeb(program)
    fetch_set = set(fetches)
    ver: Dict[str, int] = {}
    avail: Dict[tuple, Tuple[List[str], Tuple[Tuple[str, int], ...]]] = {}
    rename: Dict[str, str] = {}

    def resolve(name: str) -> str:
        while name in rename:
            name = rename[name]
        return name

    merged = 0
    kept: List[Operator] = []
    for op in block.ops:
        reads = [resolve(n) for n in dataflow.op_reads(op)]
        writes = dataflow.op_writes(op)
        attrs_key = _canonical_attrs(op)
        eligible = (
            op.type not in dataflow.PSEUDO_OPS
            and op.type not in _RANDOM_OPS
            and not dataflow.op_has_side_effects(op)
            and not any(True for _ in dataflow.op_sub_blocks(op))
            and op.attr("__recompute_seg__") is None
            and attrs_key is not None
            and bool(writes)
            and not set(reads) & set(writes)  # in-place update
            and not _writes_persistable(op, block)
        )
        if eligible:
            key = (
                op.type,
                tuple(sorted((slot, tuple(resolve(n) for n in ns if n))
                             for slot, ns in op.inputs.items())),
                tuple((n, ver.get(n, 0)) for n in sorted(set(reads))),
                tuple(sorted((slot, len([n for n in ns if n]))
                             for slot, ns in op.outputs.items())),
                attrs_key,
            )
            hit = avail.get(key)
            if hit is not None:
                canon_outs, canon_vers = hit
                # the canonical results must still hold their recorded
                # values, and the duplicate's outputs must be purely
                # local: single-writer, not fetched, never touched by a
                # sub-block (renaming only rewrites top-level reads)
                if (all(ver.get(n, 0) == v for n, v in canon_vers)
                        and all(
                            len(web.defs.get(n, ())) == 1
                            and n not in fetch_set
                            and not web.used_in_sub_block(n)
                            for n in writes)):
                    ordered_canon = dict(zip(
                        [n for _s, ns in sorted(op.outputs.items())
                         for n in ns if n],
                        canon_outs))
                    rename.update(ordered_canon)
                    merged += 1
                    continue
            else:
                out_names = [n for _s, ns in sorted(op.outputs.items())
                             for n in ns if n]
                avail[key] = (
                    out_names,
                    tuple((n, ver.get(n, 0) + 1) for n in out_names))
        for n in writes:
            ver[n] = ver.get(n, 0) + 1
        kept.append(op)

    if merged:
        block.ops = kept
        for op in block.ops:  # rewrite surviving top-level reads
            for slot, ns in op.inputs.items():
                op.inputs[slot] = [resolve(n) if n else n for n in ns]
        program._version = getattr(program, "_version", 0) + 1
        program.invalidate_cache()
    return merged


# ---------------------------------------------------------------------------
# Donation-safety analyzer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DonationEntry:
    """Static verdict for one executor state input."""

    name: str
    eligible: bool
    reason: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def state_input_names(program: Program, feed_names: Set[str],
                      fetch_names: Sequence[str]) -> List[str]:
    """Persistables the step takes as inputs — mirrors the executor's
    read-before-write classification (executor._classify)."""
    block = program.global_block()
    produced: Set[str] = set(feed_names)
    read_state: List[str] = []
    for op in block.ops:
        if op.type in dataflow.PSEUDO_OPS:
            continue
        for n in dataflow.op_reads(op):
            if n in produced or n in read_state:
                continue
            var = block.find_var(n)
            if var is not None and var.persistable:
                read_state.append(n)
        for n in dataflow.op_writes(op):
            produced.add(n)
    for n in fetch_names:
        if n not in produced and n not in read_state:
            var = block.find_var(n)
            if var is not None and var.persistable:
                read_state.append(n)
    return read_state


def donation_mask(program: Program, feed_names: Set[str],
                  fetch_names: Sequence[str]) -> Dict[str, DonationEntry]:
    """Per-state-input donation safety, proved from liveness.

    A state tensor may be donated (the Executor copies the new value
    into its storage, the old value is gone) only when the program
    provably never observes the old value after that write:

    - it must be overwritten by some top-level op (a read-only buffer
      has no aliasing write; donating it just destroys the scope copy);
    - no top-level op may read it after its last write (a later read
      would see the donated tensor's new contents);
    - it must not be read or written inside any control-flow sub-block
      (sub-blocks run inside their owning op and their reads are
      invisible to top-level last-write ordering).
    """
    web = dataflow.UseDefWeb(program)
    aliased = dataflow.sub_block_touched(program)
    mask: Dict[str, DonationEntry] = {}
    for name in state_input_names(program, feed_names, fetch_names):
        top_writes = [i for b, i in web.defs.get(name, ()) if b == 0]
        if name in aliased:
            entry = DonationEntry(name, False, "aliased into a sub-block")
        elif not top_writes:
            entry = DonationEntry(name, False,
                                  "read-only state (never overwritten)")
        else:
            last = max(top_writes)
            if web.read_after(name, 0, last):
                entry = DonationEntry(
                    name, False,
                    f"read after last write (op {last})")
            elif name in set(fetch_names):
                entry = DonationEntry(name, False, "fetched by the caller")
            else:
                entry = DonationEntry(
                    name, True, f"last write at op {last}, no later read")
        mask[name] = entry
    return mask


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptReport:
    """What the pipeline did to one program (the ``--optimize`` payload)."""

    ops_before: int = 0
    ops_after: int = 0
    rounds: int = 0
    folds: int = 0
    cse_hits: int = 0
    dce_ops_removed: int = 0
    dce_vars_removed: int = 0
    donation: Dict[str, DonationEntry] = dataclasses.field(
        default_factory=dict)
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    optimized: bool = True

    def to_dict(self) -> dict:
        return {
            "ops_before": self.ops_before,
            "ops_after": self.ops_after,
            "rounds": self.rounds,
            "folds": self.folds,
            "cse_hits": self.cse_hits,
            "dce_ops_removed": self.dce_ops_removed,
            "dce_vars_removed": self.dce_vars_removed,
            "donation": {n: e.to_dict() for n, e in self.donation.items()},
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "optimized": self.optimized,
        }

    def format(self) -> str:
        lines = [
            f"ops: {self.ops_before} -> {self.ops_after} "
            f"({self.rounds} round(s))",
            f"  constant-fold: {self.folds} op(s) folded",
            f"  cse:           {self.cse_hits} op(s) merged",
            f"  dce:           {self.dce_ops_removed} op(s), "
            f"{self.dce_vars_removed} var(s) removed",
        ]
        if self.donation:
            eligible = sum(1 for e in self.donation.values() if e.eligible)
            lines.append(
                f"  donation mask: {eligible}/{len(self.donation)} state "
                "input(s) donatable")
            for name in sorted(self.donation):
                e = self.donation[name]
                tag = "donate" if e.eligible else "hold  "
                lines.append(f"    {tag} {name}: {e.reason}")
        for d in self.diagnostics:
            lines.append("  " + d.format())
        return "\n".join(lines)


def _verifier_errors(program: Program, feeds: Optional[Set[str]],
                     fetches: Optional[Sequence[str]]) -> List[Diagnostic]:
    diags = verify_program(program, feed_names=feeds, fetch_names=fetches,
                           level=Severity.ERROR)
    return [d for d in diags if d.severity == Severity.ERROR]


def optimize_program(program: Program,
                     feed_names: Optional[Set[str]] = None,
                     fetch_names: Optional[Sequence[str]] = None,
                     max_rounds: int = 3) -> Tuple[Program, OptReport]:
    """Run the full rewrite pipeline; returns (optimized_clone, report).

    Parity gate: each pass's output is re-verified at error tier; a
    pass that introduces any error is reverted wholesale (PVO02).  A
    program that fails verification *before* optimization is returned
    untouched (PVO01) — the optimizer only transforms programs the
    verifier accepts.
    """
    report = OptReport(
        ops_before=len(program.global_block().ops),
        ops_after=len(program.global_block().ops))
    feeds = set(feed_names) if feed_names is not None else None
    fetches = list(fetch_names) if fetch_names is not None else None

    if _verifier_errors(program, feeds, fetches):
        report.optimized = False
        report.diagnostics.append(Diagnostic(
            code="PVO01", severity=Severity.INFO,
            message="optimizer skipped: program fails verification as-is",
            hint="fix the verifier errors first (paddle lint)",
            pass_name="optimizer"))
        if fetches is not None:
            report.donation = donation_mask(program, feeds or set(), fetches)
        return program, report

    work = program.clone()
    if fetches is None:
        report.diagnostics.append(Diagnostic(
            code="PVO03", severity=Severity.INFO,
            message="fetch set unknown: dead-code elimination skipped",
            hint="pass fetch targets to enable dce",
            pass_name="dce"))

    def gated(name: str, fn) -> int:
        """Run one mutating pass under the verify-or-revert gate."""
        nonlocal work
        backup = work.clone()
        try:
            changed = fn(work)
        except Exception as exc:  # a pass must never take the program down
            work = backup
            report.diagnostics.append(Diagnostic(
                code="PVO02", severity=Severity.WARNING,
                message=f"pass {name!r} raised {exc!r}; reverted",
                pass_name=name))
            return 0
        if changed and _verifier_errors(work, feeds, fetches):
            work = backup
            report.diagnostics.append(Diagnostic(
                code="PVO02", severity=Severity.WARNING,
                message=f"pass {name!r} output failed verification; "
                        "reverted",
                pass_name=name))
            return 0
        if changed:
            _M_OPS_REMOVED.inc(changed, **{"pass": name})
        return changed

    for _ in range(max_rounds):
        report.rounds += 1
        folds = gated("constant-fold", lambda p: constant_fold(p, feeds))
        cse = (gated("cse",
                     lambda p: common_subexpression_elimination(p, fetches))
               if fetches is not None else 0)
        dce = 0
        if fetches is not None:
            removed = [0, 0]

            def _dce(p):
                removed[0], removed[1] = dead_code_elimination(
                    p, feeds, fetches)
                return removed[0] + removed[1]

            dce = gated("dce", _dce)
            if dce:
                report.dce_ops_removed += removed[0]
                report.dce_vars_removed += removed[1]
        report.folds += folds
        report.cse_hits += cse
        if not (folds or cse or dce):
            break

    report.ops_after = len(work.global_block().ops)
    if fetches is not None:
        report.donation = donation_mask(work, feeds or set(), fetches)
    work.invalidate_cache()
    return work, report


# ---------------------------------------------------------------------------
# Differential parity harness
# ---------------------------------------------------------------------------


def check_parity(program: Program, feed: Dict[str, Any],
                 fetch_names: Sequence[str],
                 state: Optional[Dict[str, Any]] = None,
                 place=None) -> OptReport:
    """Execute ``program`` and its optimized form on identical state and
    feeds on ``place`` (``CUDAPlace(0)`` unless the caller passes
    another); raise AssertionError unless every fetch is bit-identical.
    Returns the optimizer report.  Test harness — imports the Executor
    lazily, since the Executor imports this package."""
    from paddle_tpu_torch.executor import Executor, Scope

    optimized, report = optimize_program(
        program, feed_names=set(feed), fetch_names=fetch_names)

    outs = []
    for prog in (program, optimized):
        exe = Executor(place)
        scope = Scope()
        # per-run copies: donation updates the first run's state in place
        scope.load_numpy({n: np.array(v, copy=True)
                          for n, v in (state or {}).items()}, exe.device)
        outs.append(exe.run(prog, feed=dict(feed),
                            fetch_list=list(fetch_names),
                            scope=scope, return_numpy=True))
    base, opt = outs
    for name, a, b in zip(fetch_names, base, opt):
        a, b = np.asarray(a), np.asarray(b)
        equal_nan = np.issubdtype(a.dtype, np.inexact)
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
                a, b, equal_nan=equal_nan):
            raise AssertionError(
                f"optimizer parity violation on fetch {name!r}: "
                f"original {a.dtype}{a.shape} vs optimized "
                f"{b.dtype}{b.shape}\n{report.format()}")
    return report


def set_donation_gauge(program_label: str,
                       mask: Dict[str, DonationEntry]) -> None:
    """Publish the donation verdict for a program's run plan."""
    _M_DONATION.set(sum(1 for e in mask.values() if e.eligible),
                    program=program_label)
