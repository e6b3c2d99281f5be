"""Sequence generation (``paddle_tpu/generation.py``): the v1
``beam_search(step, [GeneratedInput, StaticInput...], ...)`` workflow.

The step subnet runs on the place as one program: the previous token's
embedding, the linked memories and the static encoder context in, the
next-token distribution and the new memories out.  The beam bookkeeping
(expand, prune, eos) runs on the host.  Beams ride the batch dimension,
so one run of the step advances every beam at once.  The paged decode
adapter (``decode/seq2seq.py``) builds its prefill and decode programs
from the same spec and shares ``beam_select`` with the dense
``SequenceGenerator`` here, which is its oracle.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class GeneratedInput:
    """The self-feeding decoder input: the embedding of the previously
    generated word, sharing the training-time target embedding by
    name."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size                     # target vocabulary size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


class BeamGen:
    """The generation spec v1 ``beam_search`` returns; consumed by
    ``SequenceGenerator``, ``v2.infer`` and ``PagedSeq2SeqModel``."""

    def __init__(self, step, inputs, bos_id, eos_id, beam_size, max_length,
                 name=None):
        from paddle_tpu_torch.trainer_config_helpers.layers import (
            _GROUP_STACK, StaticInput)
        from paddle_tpu_torch.v2.layer import LayerOutput, _uname

        self.bos_id, self.eos_id = int(bos_id), int(eos_id)
        self.beam_size, self.max_length = int(beam_size), int(max_length)
        self.name = name
        self.static_ins = [i for i in inputs if isinstance(i, StaticInput)]
        gens = [i for i in inputs if isinstance(i, GeneratedInput)]
        if len(gens) != 1:
            raise ValueError("beam_search needs exactly one GeneratedInput")
        self.gen = gens[0]

        # config-time step invocation with placeholders (same trick as
        # recurrent_group): placeholder order mirrors the input list
        self._static_phs = [LayerOutput(_uname("gen_static"), [], None,
                                        size=s.size) for s in self.static_ins]
        self._word_ph = LayerOutput(_uname("gen_word"), [], None,
                                    size=self.gen.embedding_size)
        phs, si = [], iter(self._static_phs)
        for i in inputs:
            phs.append(self._word_ph if isinstance(i, GeneratedInput)
                       else next(si))
        self.memories: List = []
        _GROUP_STACK.append(self.memories)
        try:
            out = step(*phs)
        finally:
            _GROUP_STACK.pop()
        if isinstance(out, (list, tuple)):
            out = out[0]
        self.step_out = out

        # memory-link name map over the step subgraph
        self._by_name = {}

        def collect(lo, seen):
            if id(lo) in seen:
                return
            seen.add(id(lo))
            self._by_name[lo.name] = lo
            for p in lo.parents:
                collect(p, seen)

        collect(self.step_out, set())

    # mimic enough LayerOutput surface for parameters.create etc.
    @property
    def parents(self):
        return [s.input for s in self.static_ins]


def build_boot_vars(beam_gen: BeamGen, ctx: dict) -> List:
    """Build each memory's boot expression in ``ctx``; ``None`` means a
    zero boot.  Shared by the dense generator below and the paged
    decode adapter (``decode/seq2seq.py``)."""
    from paddle_tpu_torch.v2.layer import SeqVal

    boot_vars = []
    for m in beam_gen.memories:
        if m.parents:
            bv = m.parents[0].build(ctx)
            bv = bv.var if isinstance(bv, SeqVal) else bv
        else:
            bv = None
        boot_vars.append(bv)
    return boot_vars


def resolve_new_state_vars(beam_gen: BeamGen, sub_ctx: dict) -> List:
    """For each memory, the step-graph value it links to: the next-step
    state to fetch.  A memory bound with ``set_input`` links to that
    layer even where no step output reaches it (the LSTM unit's cell)."""
    from paddle_tpu_torch.v2.layer import SeqVal

    out = []
    for m in beam_gen.memories:
        linked = (getattr(m, "_mem_link_layer", None)
                  or beam_gen._by_name.get(m._mem_link))
        if linked is None:
            raise KeyError(f"memory link {m._mem_link!r} not found")
        lv = sub_ctx.get(id(linked))
        if lv is None:
            lv = linked.build(sub_ctx)
        out.append(lv.var if isinstance(lv, SeqVal) else lv)
    return out


def run_startup_for_missing(exe, scope, *startups) -> None:
    """Run startup programs initializing ONLY vars absent from
    ``scope``: generation reuses trained parameters by name, and the
    startup initializers would otherwise overwrite them with random
    weights."""
    for startup in startups:
        blk = startup.global_block()
        blk.ops = [op for op in blk.ops
                   if any(scope.find_var(n) is None
                          for n in op.output_arg_names)]
        exe.run(startup, scope=scope)


def beam_select(probs, scores, alive, seqs, eos_id: int, k: int):
    """One host-side beam-search bookkeeping step, the JAX package's
    verbatim (the log floor, the argpartition tie-breaking and the
    dead-beam pool merge included), so the two stay bit-identical.

    ``probs`` (k, V) next-token distributions; ``scores``/``alive``/
    ``seqs`` the beam state.  Returns ``None`` when no beam is alive
    (caller breaks), else ``(scores, seqs, alive, rows, tokens)`` where
    ``rows[j]`` is the parent beam index entry ``j`` continues from and
    ``tokens[j]`` the word it just appended."""
    logp = np.log(np.maximum(probs, 1e-20))
    # dead beams only extend with a frozen no-op
    total = np.where(alive[:, None], scores[:, None] + logp, -np.inf)
    flat = total.ravel()
    V = probs.shape[1]
    n_alive = int(alive.sum())
    if n_alive == 0:
        return None
    top = np.argpartition(-flat, min(k, flat.size - 1))[:k]
    top = top[np.argsort(-flat[top])]
    keep_rows = []
    new_seqs, new_scores, new_alive, new_tokens = [], [], [], []
    dead = [(scores[i], seqs[i]) for i in range(k) if not alive[i]]
    for t in top:
        r, w = divmod(int(t), V)
        if not np.isfinite(flat[t]):
            continue
        keep_rows.append(r)
        new_seqs.append(seqs[r] + [w])
        new_scores.append(flat[t])
        new_alive.append(w != eos_id)
        new_tokens.append(w)
    # pad back to k beams
    while len(keep_rows) < k:
        keep_rows.append(0)
        new_seqs.append(seqs[0])
        new_scores.append(-np.inf)
        new_alive.append(False)
        new_tokens.append(eos_id)
    # finished beams compete with still-alive ones; keep the best k of
    # (new + previously dead)
    pool = list(zip(new_scores, new_seqs, new_alive, keep_rows,
                    new_tokens)) + [
        (s, q, False, 0, eos_id) for s, q in dead]
    pool.sort(key=lambda e: -e[0])
    pool = pool[:k]
    return (np.array([e[0] for e in pool], np.float32),
            [e[1] for e in pool],
            np.array([e[2] for e in pool], bool),
            [e[3] for e in pool],
            [e[4] for e in pool])


class SequenceGenerator:
    """Builds the step program once and generates with host-side beam
    search, on ``place``: ``CUDAPlace(0)`` unless the caller passes
    another, and a RuntimeError rather than a CPU run when there is no
    card.  The parameters are found by name in ``parameters.scope``,
    whose tensors must live on that place."""

    def __init__(self, beam_gen: BeamGen, parameters, place=None):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.param_attr import ParamAttr
        from paddle_tpu_torch.v2.layer import SeqVal
        from paddle_tpu_torch.v2.topology import normalize_feeds
        from paddle_tpu_torch.v2.trainer import V2DataFeeder

        self.bg = beam_gen
        self.parameters = parameters
        self._main = framework.Program()
        self._startup = framework.Program()
        with framework.program_guard(self._main, self._startup):
            ctx = {}
            static_vals = [s.input.build(ctx) for s in beam_gen.static_ins]
            self._feed_types = normalize_feeds(ctx.get("@feeds", []))
            self._feeder = V2DataFeeder(self._feed_types)

            # previous-token embedding, sharing the training-time table
            word = L.data(name="@gen_word", shape=[-1, 1], dtype="int64",
                          append_batch_size=False)
            emb = L.embedding(
                word, size=[beam_gen.gen.size, beam_gen.gen.embedding_size],
                param_attr=ParamAttr(name=beam_gen.gen.embedding_name))
            emb = L.reshape(emb, [-1, beam_gen.gen.embedding_size])

            # memory state feeds + boot exprs
            self._state_names = []
            self._boot_vars = build_boot_vars(beam_gen, ctx)
            sub_ctx = {id(beam_gen._word_ph): emb}
            for ph, v in zip(beam_gen._static_phs, static_vals):
                sub_ctx[id(ph)] = v
            for i, m in enumerate(beam_gen.memories):
                sname = f"@gen_state_{i}"
                sv = L.data(name=sname, shape=[-1, m.size], dtype="float32",
                            append_batch_size=False)
                self._state_names.append(sname)
                sub_ctx[id(m)] = sv

            out = beam_gen.step_out.build(sub_ctx)
            self._probs_var = out.var if isinstance(out, SeqVal) else out
            self._new_state_vars = resolve_new_state_vars(beam_gen, sub_ctx)

        self._exe = Executor(place)
        self.place = self._exe.place
        self._scope = parameters.scope
        run_startup_for_missing(self._exe, self._scope, self._startup)

    def _run(self, feed, fetch):
        # scope passed explicitly, NOT via scope_guard: the guard
        # mutates the process-global scope stack, and concurrent
        # generators on other threads would race on it
        return self._exe.run(self._main, feed=feed, fetch_list=fetch,
                             scope=self._scope)

    def _base_feed(self, row):
        return self._feeder.feed([row]) if self._feed_types else {}

    def _boots(self, feed_1):
        """The memories' boot values for one row: the step program is
        run whole (every op runs, so the step's own feeds are given as
        zeros, which no boot expression reads) and only the boots are
        fetched."""
        boot_fetch = [v for v in self._boot_vars if v is not None]
        if not boot_fetch:
            return iter([])
        feed = dict(feed_1)
        feed["@gen_word"] = np.zeros((1, 1), np.int64)
        for n, m in zip(self._state_names, self.bg.memories):
            feed[n] = np.zeros((1, m.size), np.float32)
        return iter(self._run(feed, boot_fetch))

    def generate(self, row, beam_size: Optional[int] = None,
                 max_length: Optional[int] = None) -> List[tuple]:
        """Generate for ONE input row (the static-input fields, v2
        reader order).  Returns the beam as [(score, [ids...]), ...]
        best-first; ids exclude bos and include eos if produced.

        ``beam_size``/``max_length`` override the spec per call without
        rebuilding anything: the beam width only changes the step feed's
        batch dimension, and the Executor keys its plans by shape."""
        bg = self.bg
        k = int(beam_size) if beam_size is not None else bg.beam_size
        if k < 1:
            raise ValueError(f"beam_size must be >= 1, got {k}")
        steps = (int(max_length) if max_length is not None
                 else bg.max_length)
        base = self._base_feed(row)

        def tile(arr):
            return np.repeat(np.asarray(arr), k, axis=0)

        feed_k = {n: tile(v) for n, v in base.items()}

        # boot states (computed once from the static feeds, then tiled)
        states = []
        boots = self._boots({n: np.asarray(v) for n, v in base.items()})
        for m, bv in zip(bg.memories, self._boot_vars):
            if bv is None:
                states.append(np.zeros((k, m.size), np.float32))
            else:
                states.append(tile(np.asarray(next(boots)).reshape(1, -1)))

        tokens = np.full((k, 1), bg.bos_id, np.int64)
        scores = np.full((k,), -np.inf, np.float32)
        scores[0] = 0.0                   # identical beams start as one
        alive = np.ones((k,), bool)
        seqs = [[] for _ in range(k)]

        for _ in range(steps):
            feed = dict(feed_k)
            feed["@gen_word"] = tokens
            for n, s in zip(self._state_names, states):
                feed[n] = s.astype(np.float32)
            outs = self._run(feed, [self._probs_var] + self._new_state_vars)
            probs = np.asarray(outs[0]).reshape(k, -1)
            new_states = [np.asarray(o) for o in outs[1:]]
            sel = beam_select(probs, scores, alive, seqs, bg.eos_id, k)
            if sel is None:
                break
            scores, seqs, alive, rows, toks = sel
            tokens = np.array([[t] for t in toks], np.int64)
            states = [s[rows] for s in new_states]
            if not alive.any():
                break

        order = np.argsort(-scores)
        return [(float(scores[i]), list(seqs[i])) for i in order
                if np.isfinite(scores[i])]

    def generate_greedy(self, row,
                        max_length: Optional[int] = None) -> List[int]:
        """Dense greedy decode for ONE row: argmax token per step, stop
        at eos or the length budget.  The oracle the paged decode
        (``decode/seq2seq.py``) is held to token for token: the same
        step program, one sequence, no paging."""
        bg = self.bg
        steps = (int(max_length) if max_length is not None
                 else bg.max_length)
        base = self._base_feed(row)
        feed_1 = {n: np.asarray(v) for n, v in base.items()}

        states = []
        boots = self._boots(feed_1)
        for m, bv in zip(bg.memories, self._boot_vars):
            if bv is None:
                states.append(np.zeros((1, m.size), np.float32))
            else:
                states.append(np.asarray(next(boots)).reshape(1, -1)
                              .astype(np.float32))

        token = bg.bos_id
        out: List[int] = []
        for _ in range(steps):
            feed = dict(feed_1)
            feed["@gen_word"] = np.asarray([[token]], np.int64)
            for n, s in zip(self._state_names, states):
                feed[n] = s.astype(np.float32)
            outs = self._run(feed, [self._probs_var] + self._new_state_vars)
            probs = np.asarray(outs[0]).reshape(-1)
            states = [np.asarray(o) for o in outs[1:]]
            token = int(np.argmax(probs))
            out.append(token)
            if token == bg.eos_id:
                break
        return out
