"""Def-use and block-walking helpers for the program verifier, the
optimizer and the Executor (``paddle_tpu/analysis/dataflow.py``).

The whole Program is data, so the analysis layer walks it like a
compiler IR: per-block def-use chains, recursive descent into
Block-valued attrs (while / recurrent / conditional_block sub-blocks),
and liveness from the fetch set.  ``sub_block_external_reads`` is the
port's one answer to "what does this op's sub-block read from the
enclosing scope": the Executor's release plan, ``Program.prune`` and the
control-flow ops all ask it.  Everything in this module is read-only
over the IR.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Set, Tuple

from paddle_tpu_torch.framework import Block, Operator, Program

# Executor pseudo-ops: present in pruned/serialized programs, skipped by
# the Executor's plan build (executor.py _classify).
PSEUDO_OPS = frozenset({"feed", "fetch"})

# Ops whose observable effect is not (only) a dataflow output —
# liveness must keep them even when nothing reads their outputs.
# Includes the distributed RPC pair (send ships a gradient to a
# parameter server, recv pulls the fresh value back — both fire a wire
# round-trip whether or not anything reads Out) and the
# checkpoint-writing ops (save persists scope state to disk): pruning
# any of these would silently drop a distributed update or a
# checkpoint commit.
SIDE_EFFECT_OPS = frozenset(
    {"print", "save", "grad_printer", "seq_text_printer",
     "send", "recv", "ncclInit"}
)


def op_has_side_effects(op: Operator) -> bool:
    """Conservative side-effect test for elimination decisions: named
    side-effect ops, plus any op that declares NO outputs at all — an
    op with nothing to write can only exist for its effect (send, save,
    ncclInit all match), so an unknown output-less op is never safe to
    prune."""
    if op.type in SIDE_EFFECT_OPS:
        return True
    return not any(n for ns in op.outputs.values() for n in ns)

# conditional_block's false branch passes through the outputs' prior
# values, so its outputs are implicit *reads* as well as writes (as the
# JAX package's analysis has it).
_READS_OWN_OUTPUTS = frozenset({"conditional_block"})


def op_reads(op: Operator) -> List[str]:
    """Non-empty input names, plus op-specific implicit reads."""
    reads = [n for ns in op.inputs.values() for n in ns if n]
    if op.type in _READS_OWN_OUTPUTS:
        reads += [n for n in op.output("Out") if n]
    return reads


def op_writes(op: Operator) -> List[str]:
    return [n for ns in op.outputs.values() for n in ns if n]


def op_sub_blocks(op: Operator) -> List[Tuple[str, Block]]:
    """Block-valued attrs, i.e. the op's control-flow sub-blocks."""
    return [(k, v) for k, v in op.attrs.items() if isinstance(v, Block)]


def sub_block_bound_names(op: Operator) -> Set[str]:
    """Names the op binds in the sub-block scope before running it
    (recurrent injects loop state and per-step input slices; see
    ops/control_flow_ops.py _recurrent)."""
    bound: Set[str] = set()
    for key in ("state_names", "step_input_names"):
        v = op.attr(key)
        if isinstance(v, (list, tuple)):
            bound.update(n for n in v if isinstance(n, str) and n)
    return bound


def block_writes(block: Block, recursive: bool = True,
                 _seen: Optional[Set[int]] = None) -> Set[str]:
    """All names written by the block's ops (optionally including
    nested sub-blocks, whose writes land in the same traced scope)."""
    _seen = set() if _seen is None else _seen
    if id(block) in _seen:
        return set()
    _seen.add(id(block))
    out: Set[str] = set()
    for op in block.ops:
        out.update(op_writes(op))
        if recursive:
            for _, sub in op_sub_blocks(op):
                out |= block_writes(sub, recursive=True, _seen=_seen)
    return out


def program_writes(program: Program) -> Set[str]:
    """Every name any op (in any reachable block) writes."""
    return block_writes(program.global_block(), recursive=True)


def walk_ops(block: Block,
             _seen: Optional[Set[int]] = None
             ) -> Iterator[Tuple[Block, int, Operator]]:
    """Yield (block, op_idx, op) for the block and its sub-blocks."""
    _seen = set() if _seen is None else _seen
    if id(block) in _seen:
        return
    _seen.add(id(block))
    for idx, op in enumerate(block.ops):
        yield block, idx, op
        for _, sub in op_sub_blocks(op):
            yield from walk_ops(sub, _seen)


def implicit_feed_vars(program: Program) -> Set[str]:
    """Declared, non-persistable variables no op ever writes: the
    program's input surface (what ``layers.data`` declares).  Used when
    the caller gives no explicit feed set (lint mode)."""
    written = program_writes(program)
    feeds: Set[str] = set()
    for block in program.blocks:
        for name, var in block.vars.items():
            if not var.persistable and name not in written:
                feeds.add(name)
    return feeds


def declared_dtype(block: Block, name: str) -> Optional[str]:
    var = block.find_var(name)
    return var.dtype if var is not None else None


def dtype_family(dtype: Optional[str]) -> Optional[str]:
    if dtype is None:
        return None
    if dtype == "bool":
        return "bool"
    if dtype.startswith(("float", "bfloat")):
        return "float"
    if dtype.startswith(("int", "uint")):
        return "int"
    return None


def producers(block: Block) -> Dict[str, List[int]]:
    """name -> ordered list of op indices that write it (this block
    only; sub-block writes excluded so WAW stays branch-local)."""
    out: Dict[str, List[int]] = {}
    for idx, op in enumerate(block.ops):
        for n in op_writes(op):
            out.setdefault(n, []).append(idx)
    return out


# ---------------------------------------------------------------------------
# Dataflow engine (liveness / reaching definitions / use-def webs).
#
# The verifier's passes each re-derived ad-hoc slices of this
# information; the optimizer (analysis/optimize.py) needs it as first-
# class data, computed once per program.  Control-flow sub-blocks are
# handled the way the Executor runs them: a sub-block executes *inside*
# its owning op, reading outer names from the run's values, so at the
# owning block's level a control-flow op reads everything its
# sub-blocks read from outside and writes its own declared outputs.
# ---------------------------------------------------------------------------


def sub_block_external_reads(op: Operator) -> Set[str]:
    """Names an op's sub-blocks read from the enclosing scope: union of
    sub-block op inputs (recursively) minus names produced earlier
    inside the same sub-block (reference: framework/prune.cc:133)."""
    reads: Set[str] = set()
    for _, sub in op_sub_blocks(op):
        produced: Set[str] = set(sub_block_bound_names(op))
        for sub_op in sub.ops:
            reads |= set(n for n in op_reads(sub_op) if n) - produced
            reads |= sub_block_external_reads(sub_op)
            produced |= set(op_writes(sub_op))
    return reads


def effective_reads(op: Operator) -> Set[str]:
    """Everything executing this op consumes from its block's scope:
    its declared inputs plus whatever its control-flow sub-blocks pull
    from outside themselves."""
    reads = set(op_reads(op))
    if any(True for _ in op_sub_blocks(op)):
        reads |= sub_block_external_reads(op)
    return reads


def sub_block_touched(program: Program) -> Set[str]:
    """Every name read OR written by any op inside any control-flow
    sub-block.  A buffer on this list is aliased into a nested scope —
    the donation analyzer refuses to donate it."""
    touched: Set[str] = set()
    for block, _idx, op in walk_ops(program.global_block()):
        if block.idx == 0:
            continue
        touched.update(op_reads(op))
        touched.update(op_writes(op))
    return touched


def liveness(block: Block, live_out: Set[str]) -> List[Set[str]]:
    """Backward liveness: ``result[i]`` is the set of names live
    immediately BEFORE op ``i`` runs (standard transfer
    ``live_in = reads ∪ (live_out − writes)``).  Sub-block reads count
    as reads of the owning op; ``live_out`` seeds the exit set
    (fetches + state the caller observes)."""
    live = set(live_out)
    before: List[Set[str]] = [set()] * len(block.ops)
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        live = (live - set(op_writes(op))) | effective_reads(op)
        before[idx] = set(live)
    return before


def reaching_definitions(block: Block,
                         entry: Optional[Set[str]] = None
                         ) -> List[Dict[str, Tuple[int, ...]]]:
    """Forward reaching definitions: ``result[i]`` maps each name to
    the op indices whose writes can reach op ``i``'s reads (index -1 =
    defined at entry: fed / scope state).  Straight-line per block —
    the executor runs a block's op list exactly in order, so gen/kill
    needs no fixpoint here."""
    reaching: Dict[str, Tuple[int, ...]] = {
        n: (-1,) for n in (entry or set())}
    out: List[Dict[str, Tuple[int, ...]]] = []
    for idx, op in enumerate(block.ops):
        out.append(dict(reaching))
        for n in op_writes(op):
            reaching[n] = (idx,)  # a straight-line write kills prior defs
    return out


class UseDefWeb:
    """Whole-program def/use index over every block (sub-blocks
    included): ``defs[name]`` / ``uses[name]`` are ordered lists of
    ``(block_idx, op_idx)`` sites.  Sub-block uses are what make a name
    "aliased into a sub-block" for the donation analyzer."""

    def __init__(self, program: Program):
        self.defs: Dict[str, List[Tuple[int, int]]] = {}
        self.uses: Dict[str, List[Tuple[int, int]]] = {}
        for block, idx, op in walk_ops(program.global_block()):
            site = (block.idx, idx)
            for n in op_writes(op):
                self.defs.setdefault(n, []).append(site)
            for n in op_reads(op):
                self.uses.setdefault(n, []).append(site)

    def single_writer(self, name: str) -> Optional[Tuple[int, int]]:
        sites = self.defs.get(name, [])
        return sites[0] if len(sites) == 1 else None

    def used_in_sub_block(self, name: str) -> bool:
        return any(b != 0 for b, _ in self.uses.get(name, ()))

    def read_after(self, name: str, block_idx: int, op_idx: int) -> bool:
        """Any top-level read of ``name`` strictly after the given
        top-level site (the donation analyzer's later-read test)."""
        return any(b == block_idx and i > op_idx
                   for b, i in self.uses.get(name, ()))
