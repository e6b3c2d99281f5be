"""The built-in lint/verify passes.

Each pass is a function over a ``PassContext`` registered via
``@register_pass(name, tier)``; the tier is the most severe diagnostic
the pass can emit, and the pass manager only runs passes at or above
the requested level (the Executor's plan-miss gate runs error tier
only).

Stable diagnostic codes (asserted by tests — treat as API):

  PVE01  read-before-write / undefined input
  PVE02  dangling fetch target
  PVE03  dtype clash on an arithmetic op
  PVE04  malformed control-flow sub-block
  PVE05  unknown (unregistered) op type
  PVE06  @GRAD variable without a forward counterpart
  PVE07  registered infer_shape rule rejected the op
  PVW01  write-after-write (earlier value dead)
  PVW02  persistable-write hazard
  PVW03  fed variable never read
  PVW04  gradient/forward dtype mismatch
  PVW05  same-family dtype width mismatch
  PVI01  dead op (result unreachable from fetches/state)
  PVI02  dead variable (declared, never used)

Optimizer diagnostics (emitted by analysis/optimize.py's PassPipeline,
same Diagnostic records, same stability contract):

  PVO01  optimizer skipped: input program already fails verification
  PVO02  rewrite pass output failed verification; pass reverted
  PVO03  dce/slice skipped: fetch set unknown
"""

from __future__ import annotations

from typing import Set

from paddle_tpu_torch.framework import GRAD_SUFFIX, Block, Parameter
from paddle_tpu_torch.registry import OpRegistry, SkipInferShape
from paddle_tpu_torch.analysis import dataflow
from paddle_tpu_torch.analysis.verify import PassContext, Severity, register_pass

_ARITH_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "mul",
})


# ---------------------------------------------------------------------------
# Error tier
# ---------------------------------------------------------------------------


@register_pass("def-before-use", Severity.ERROR)
def check_def_before_use(ctx: PassContext):
    """Every op input must be fed, produced by an earlier op, or
    persistable (scope state).  Top-level ops are checked in program
    order; sub-block reads are checked unordered (loop-carried state in
    ``while``/``recurrent`` legally reads names written later in the
    same block).  Malformed sub-block attrs surface here as PVE04."""
    program = ctx.program
    defined = set(ctx.feed_surface())
    _walk(ctx, program.global_block(), defined, ordered=True, seen=set())


def _walk(ctx: PassContext, block: Block, defined: Set[str],
          ordered: bool, seen: Set[int]):
    if id(block) in seen:
        return
    seen.add(id(block))
    # only unordered (sub-block) regions consult the full write set
    local_writes = (dataflow.block_writes(block, recursive=True)
                    if not ordered else frozenset())
    for idx, op in enumerate(block.ops):
        if op.type in dataflow.PSEUDO_OPS:
            defined.update(dataflow.op_writes(op))
            continue
        for name in dataflow.op_reads(op):
            if name in defined:
                continue
            if not ordered and name in local_writes:
                continue  # unordered region: loop carry / branch writes
            var = block.find_var(name)
            if var is not None and var.persistable:
                continue  # comes from scope state at run time
            # (lint mode needs no implicit-feed test here: `defined` is
            # seeded from feed_surface(), which IS implicit_feeds then)
            ctx.emit(
                "PVE01", Severity.ERROR,
                f"op reads {name!r} before any write",
                block_idx=block.idx, op_idx=idx, op_type=op.type, var=name,
                hint="feed it, produce it with an earlier op, or mark the "
                     "variable persistable")
        for attr_key, sub in dataflow.op_sub_blocks(op):
            if not _sub_block_ok(ctx, block, idx, op, attr_key, sub, seen):
                continue
            inner = defined | dataflow.sub_block_bound_names(op)
            _walk(ctx, sub, inner, ordered=False, seen=seen)
        defined.update(dataflow.op_writes(op))


def _sub_block_ok(ctx: PassContext, block: Block, idx: int, op, attr_key: str,
                  sub: Block, seen: Set[int]) -> bool:
    """Validate a Block-valued attr (PVE04); False skips the descent."""

    def bad(why: str) -> bool:
        ctx.emit("PVE04", Severity.ERROR,
                 f"attr {attr_key!r} references a malformed sub-block: {why}",
                 block_idx=block.idx, op_idx=idx, op_type=op.type,
                 hint="sub-blocks must be created with "
                      "program.create_block() on the same program")
        return False

    if sub.program is not ctx.program:
        return bad("it belongs to a different Program")
    if not (0 <= sub.idx < len(ctx.program.blocks)):
        return bad(f"block idx {sub.idx} out of range")
    if ctx.program.blocks[sub.idx] is not sub:
        return bad(f"block idx {sub.idx} does not match program.blocks")
    if id(sub) in seen:
        return bad("sub-block cycle (block reachable from itself)")
    return True


@register_pass("unknown-op", Severity.ERROR)
def check_unknown_ops(ctx: PassContext):
    """Every op type must resolve in the OpRegistry (``*_grad`` types
    synthesize from the forward rule, so they resolve too)."""
    for block, idx, op in dataflow.walk_ops(ctx.program.global_block()):
        if op.type in dataflow.PSEUDO_OPS:
            continue
        if OpRegistry.get(op.type, none_ok=True) is not None:
            continue
        close = OpRegistry.suggest(op.type, n=1)
        ctx.emit("PVE05", Severity.ERROR,
                 f"op type {op.type!r} is not registered",
                 block_idx=block.idx, op_idx=idx, op_type=op.type,
                 hint=(f"did you mean {close[0]!r}?" if close
                       else "register it with @register_op"))


@register_pass("fetch-reachability", Severity.ERROR)
def check_fetch_reachability(ctx: PassContext):
    """Every fetch target must be produced by some op, fed, or
    persistable — otherwise the run dies on a KeyError long after the
    actual mistake.  Skipped when the fetch list is unknown."""
    if not ctx.fetches:
        return
    available = ctx.all_writes | ctx.feed_surface()
    block = ctx.program.global_block()
    for name in ctx.fetches:
        if name in available:
            continue
        var = block.find_var(name)
        if var is not None and var.persistable:
            continue
        ctx.emit("PVE02", Severity.ERROR,
                 f"fetch target {name!r} is never written by any op "
                 f"(fetch list: {list(ctx.fetches)!r})",
                 var=name,
                 hint="fetch a variable some op produces, feed it, or "
                      "mark it persistable")


@register_pass("dtype-flow", Severity.ERROR)
def check_dtype_flow(ctx: PassContext):
    """Arithmetic ops over operands from different dtype families
    (float vs int vs bool) are an error — torch would either refuse or
    silently promote; same-family width mixes (float32+float64,
    int32+int64) downgrade to a warning since the executor's feed
    conversion often papers over them."""
    for block, idx, op in dataflow.walk_ops(ctx.program.global_block()):
        if op.type not in _ARITH_BINARY and op.type != "sum":
            continue
        names = ([n for n in op.input("X") if n]
                 + [n for n in op.input("Y") if n])
        typed = [(n, dataflow.declared_dtype(block, n)) for n in names]
        typed = [(n, d) for n, d in typed if d is not None]
        if len(typed) < 2:
            continue
        base_name, base = typed[0]
        for name, dtype in typed[1:]:
            if dtype == base:
                continue
            fam_a = dataflow.dtype_family(base)
            fam_b = dataflow.dtype_family(dtype)
            if fam_a != fam_b:
                ctx.emit("PVE03", Severity.ERROR,
                         f"dtype clash: {base_name!r} is {base} but "
                         f"{name!r} is {dtype}",
                         block_idx=block.idx, op_idx=idx, op_type=op.type,
                         var=name,
                         hint="insert a cast op (layers.cast) on one operand")
            else:
                ctx.emit("PVW05", Severity.WARNING,
                         f"dtype width mismatch: {base_name!r} is {base} "
                         f"but {name!r} is {dtype}",
                         block_idx=block.idx, op_idx=idx, op_type=op.type,
                         var=name,
                         hint="widths are silently promoted; cast "
                              "explicitly if intended")
            break


@register_pass("shape-infer", Severity.ERROR)
def check_shape_inference(ctx: PassContext):
    """Re-run each op's registered ``infer_shape`` rule over the built
    program.  ``SkipInferShape`` means "cannot infer statically" and is
    fine; any other exception is the rule rejecting the op's metadata."""
    ran_any = False
    for block, idx, op in dataflow.walk_ops(ctx.program.global_block()):
        info = OpRegistry.get(op.type, none_ok=True)
        if info is None or info.infer_shape is None:
            continue
        try:
            ran_any = True
            info.infer_shape(op, block)
        except SkipInferShape:
            continue
        except Exception as exc:  # the rule rejected the op
            ctx.emit("PVE07", Severity.ERROR,
                     f"infer_shape rejected the op: {exc}",
                     block_idx=block.idx, op_idx=idx, op_type=op.type,
                     hint="fix the op's input/output shapes or dtypes")
    if ran_any:
        # rules may backfill var metadata (shape/lod) the program was
        # built without (e.g. loaded via Program.from_dict, which skips
        # append-time InferShape); drop any cached content fingerprint
        # so the executor's plan-cache key reflects the filled state
        ctx.program.invalidate_cache()


@register_pass("grad-pairing", Severity.ERROR)
def check_grad_pairing(ctx: PassContext):
    """After append_backward every ``x@GRAD`` (and ``@RENAME`` alias)
    must pair with a declared forward ``x``; mismatched grad/forward
    dtypes are a warning (the vjp would emit the forward dtype)."""
    for block in ctx.program.blocks:
        for name, var in block.vars.items():
            if GRAD_SUFFIX not in name:
                continue
            base = name.split(GRAD_SUFFIX, 1)[0]
            if not base:
                continue
            fwd = block.find_var(base)
            if fwd is None:
                ctx.emit("PVE06", Severity.ERROR,
                         f"gradient variable {name!r} has no forward "
                         f"counterpart {base!r}",
                         block_idx=block.idx, var=name,
                         hint="gradient vars are created by "
                              "append_backward; do not hand-declare them")
            elif fwd.dtype != var.dtype:
                ctx.emit("PVW04", Severity.WARNING,
                         f"gradient {name!r} is {var.dtype} but forward "
                         f"{base!r} is {fwd.dtype}",
                         block_idx=block.idx, var=name,
                         hint="grads inherit the forward dtype; a clash "
                              "means the var was redeclared")


# ---------------------------------------------------------------------------
# Warning tier
# ---------------------------------------------------------------------------


@register_pass("waw-overwrite", Severity.WARNING)
def check_waw(ctx: PassContext):
    """Two writes to the same name with no read in between: the first
    value is dead — usually a copy-paste slip or a shadowed temp.
    In-place updates (op reads what it writes) are exempt."""
    for block in ctx.program.blocks:
        writers = dataflow.producers(block)
        for name, idxs in writers.items():
            for prev, cur in zip(idxs, idxs[1:]):
                cur_op = block.ops[cur]
                if name in dataflow.op_reads(cur_op):
                    continue  # read-modify-write
                if any(_op_or_sub_reads(block.ops[i], name)
                       for i in range(prev + 1, cur)):
                    continue
                ctx.emit("PVW01", Severity.WARNING,
                         f"{name!r} written at op {prev} is overwritten "
                         f"unread (write-after-write)",
                         block_idx=block.idx, op_idx=cur,
                         op_type=cur_op.type, var=name,
                         hint="drop the first write or rename the second "
                              "target")


def _op_or_sub_reads(op, name: str) -> bool:
    if name in dataflow.op_reads(op):
        return True
    for _, sub in dataflow.op_sub_blocks(op):
        for _b, _i, sub_op in dataflow.walk_ops(sub):
            if name in dataflow.op_reads(sub_op):
                return True
    return False


@register_pass("persistable-hazard", Severity.WARNING)
def check_persistable_writes(ctx: PassContext):
    """Persistable state threads through the step (executor.py);
    hazards: (a) the same persistable written by two ops
    in one step (double update — last silently wins), (b) a trainable
    Parameter blindly overwritten by a non-optimizer, non-initializer
    op (clobbers checkpointed state)."""
    block = ctx.program.global_block()
    writers = dataflow.producers(block)
    for name, idxs in writers.items():
        var = block.find_var(name)
        if var is None or not var.persistable:
            continue
        if len(idxs) > 1:
            ctx.emit("PVW02", Severity.WARNING,
                     f"persistable {name!r} is written by ops "
                     f"{list(idxs)} in one step; the last write wins",
                     block_idx=block.idx, op_idx=idxs[-1],
                     op_type=block.ops[idxs[-1]].type, var=name,
                     hint="fold the updates into one op or split the "
                          "program")
            continue
        op = block.ops[idxs[0]]
        if not isinstance(var, Parameter):
            continue
        reads = dataflow.op_reads(op)
        is_init = not reads  # pure initializer (fill/load/random)
        if name in reads or is_init:
            continue
        if op.attr("op_role") == "optimize" or op.type.endswith("_grad"):
            continue
        ctx.emit("PVW02", Severity.WARNING,
                 f"parameter {name!r} is overwritten by {op.type!r} "
                 "without reading it (outside any optimizer update)",
                 block_idx=block.idx, op_idx=idxs[0], op_type=op.type,
                 var=name,
                 hint="parameter writes outside op_role='optimize' "
                      "clobber trained state")


@register_pass("feed-usage", Severity.WARNING)
def check_feed_usage(ctx: PassContext):
    """Explicitly-fed names nothing reads: dead host->device transfers
    every step.  Only runs when the caller supplied the feed set."""
    if not ctx.feeds:
        return
    read: Set[str] = set()
    for _b, _i, op in dataflow.walk_ops(ctx.program.global_block()):
        read.update(dataflow.op_reads(op))
    for name in sorted(ctx.feeds):
        if name in read or (ctx.fetches and name in ctx.fetches):
            continue
        ctx.emit("PVW03", Severity.WARNING,
                 f"fed variable {name!r} is never read by any op",
                 var=name,
                 hint="drop it from the feed dict")


# ---------------------------------------------------------------------------
# Info tier
# ---------------------------------------------------------------------------


@register_pass("dead-code", Severity.INFO)
def check_dead_code(ctx: PassContext):
    """Backward liveness from the fetch set: ops whose results cannot
    reach a fetch, persistable state, or a side effect are dead weight
    in every run.  Needs the fetch list; skipped otherwise."""
    if ctx.fetches is None:
        return
    block = ctx.program.global_block()
    live: Set[str] = set(ctx.fetches)
    dead_ops = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        writes = dataflow.op_writes(op)
        keep = (dataflow.op_has_side_effects(op)
                or op.type in dataflow.PSEUDO_OPS
                or any(n in live for n in writes))
        if not keep:
            for n in writes:
                var = block.find_var(n)
                if var is not None and var.persistable:
                    keep = True
                    break
        if keep:
            live.update(dataflow.op_reads(op))
            for _, sub in dataflow.op_sub_blocks(op):
                for _b, _i, sub_op in dataflow.walk_ops(sub):
                    live.update(dataflow.op_reads(sub_op))
        else:
            dead_ops.append((idx, op))
    for idx, op in reversed(dead_ops):
        ctx.emit("PVI01", Severity.INFO,
                 "op result never reaches a fetch, persistable, or "
                 "side effect",
                 block_idx=block.idx, op_idx=idx, op_type=op.type,
                 hint="prune it with Program.prune(targets)")
    used: Set[str] = set(ctx.fetches) | ctx.feed_surface()
    for _b, _i, op in dataflow.walk_ops(block):
        used.update(dataflow.op_reads(op))
        used.update(dataflow.op_writes(op))
    for blk in ctx.program.blocks:
        for name in blk.vars:
            if name not in used:
                ctx.emit("PVI02", Severity.INFO,
                         f"variable {name!r} is declared but never used",
                         block_idx=blk.idx, var=name,
                         hint="delete the declaration")
