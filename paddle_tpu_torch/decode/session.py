"""DecodeSession: continuous batching at token granularity
(``paddle_tpu/decode/session.py``; host code, the JAX package's).

The session owns ``max_slots`` fixed batch lanes.  Every scheduler tick
(``step()``):

1. **Admit**: pending requests claim open slots while the page pool can
   hold their whole context (prompt + every token they may generate —
   reserved up front, so a running sequence can never hit mid-flight
   exhaustion).  Admission runs the model's prefill and writes the
   context into freshly allocated pages.
2. **Decode**: ONE step over all ``max_slots`` lanes — inactive lanes
   ride along masked (their page tables point at the reserved null
   page), so the step's shapes never change as the batch composition
   churns.
3. **Evict**: finished sequences (EOS or token budget) leave their
   slot, their pages return to the allocator free list, and their
   waiter is notified.

The model behind the session is duck-typed (``TinyDecoderLM`` for
transformer self-attention KV); its ``dense_greedy`` is the exact dense
oracle the parity tests pin this against.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from paddle_tpu_torch.decode.paged_kv import PoolExhausted, cow_split
from paddle_tpu_torch.decode.spec import accept_greedy, observe_chunk
from paddle_tpu_torch.generation import beam_select
from paddle_tpu_torch.observability import metrics as _metrics

_M_ACTIVE = _metrics.gauge(
    "decode_active_slots", "sequences currently decoding in the session")
_M_WAITING = _metrics.gauge(
    "decode_waiting_requests", "admitted-but-queued generation requests")
_M_STEPS = _metrics.counter(
    "decode_steps_total", "fixed-shape decode steps dispatched")
_M_TOKENS = _metrics.counter(
    "decode_tokens_total", "tokens generated across all sequences")
_M_REFUSED = _metrics.counter(
    "decode_admission_refused_total",
    "generation requests refused at admission, by reason")
_M_STEP_SEC = _metrics.histogram(
    "decode_step_seconds", "wall time per batched decode step")
_M_PREFILL_SEC = _metrics.histogram(
    "decode_prefill_seconds", "wall time per sequence prefill (admission)")
_M_TTFT = _metrics.histogram(
    "decode_ttft_seconds", "submit-to-first-token latency per sequence")
_M_REQ_SEC = _metrics.histogram(
    "decode_request_seconds", "submit-to-finish latency per sequence")
_M_STEP_FAIL = _metrics.counter(
    "decode_step_failures_total",
    "decode/verify dispatches that raised (contained per-slot, "
    "stepper survives)")
_M_CANCELLED = _metrics.counter(
    "decode_cancelled_total",
    "generation requests cancelled by their consumer (pages freed)")


class AdmissionRefused(RuntimeError):
    """The session cannot take this request (pool exhausted / too long
    / queue full).  Serving maps this to 503 — graceful refusal, never
    a crash of live sequences."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class DecodeRequest:
    """One generation request: prompt in, streamed tokens out.

    ``temperature``/``top_k``/``seed`` opt into per-slot sampling:
    temperature scales the next-token distribution (0/None = greedy
    argmax), top_k keeps only the k most likely tokens, and seed pins
    the slot's own RNG so a request replays bit-identically regardless
    of what else shares the batch.  top_k/seed without temperature is
    rejected (ValueError) rather than silently decoded greedily."""

    def __init__(self, prompt, max_new_tokens: int = 32,
                 on_token: Optional[Callable[[int], None]] = None,
                 deadline: Optional[float] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 seed: Optional[int] = None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.on_token = on_token
        self.deadline = deadline            # time.monotonic timestamp
        if (top_k or seed is not None) and not temperature:
            raise ValueError(
                "top_k/seed require temperature > 0; without it decoding "
                "is greedy argmax and they would be silently ignored")
        self.temperature = (None if not temperature
                            else float(temperature))
        self.top_k = None if not top_k else int(top_k)
        self.seed = seed
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None   # eos|length|deadline|error
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.step_failures = 0         # decode steps that died under us
        self.cancelled = False         # consumer gone; evict next tick
        self._done = threading.Event()

    # -- waiter side --------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    # -- session side -------------------------------------------------------

    def _emit(self, token: int) -> None:
        now = time.monotonic()
        if self.first_token_at is None:
            self.first_token_at = now
            _M_TTFT.observe(now - self.submitted_at)
        self.tokens.append(int(token))
        if self.on_token is not None:
            try:
                self.on_token(int(token))
            except Exception:
                pass  # a dead stream consumer must not kill the batch

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        if self._done.is_set():
            return
        self.finish_reason = reason
        self.error = error
        _M_REQ_SEC.observe(time.monotonic() - self.submitted_at)
        self._done.set()

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def cancel(self) -> None:
        """Consumer-side abandon (disconnected stream): flag the
        request; the stepper evicts the slot and frees its pages at the
        next tick (never cross-thread surgery on live slot state)."""
        self.cancelled = True


class BeamRequest(DecodeRequest):
    """Beam-search generation through the session: the beam's k
    hypotheses ride k sibling slots forked from one prefilled prompt
    (pages shared copy-on-write), selection reuses the exact host-side
    bookkeeping of the dense ``SequenceGenerator`` oracle
    (``generation.beam_select``).  ``result()`` returns the best
    hypothesis' ids; ``beams`` holds the full [(score, ids), ...]
    best-first."""

    def __init__(self, prompt, beam_size: int, max_new_tokens: int = 32,
                 deadline: Optional[float] = None):
        super().__init__(prompt, max_new_tokens=max_new_tokens,
                         deadline=deadline)
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        self.beam_size = int(beam_size)
        self.beams: Optional[List[tuple]] = None


class _Slot:
    __slots__ = ("req", "pages", "ctx_len", "new_tokens", "group",
                 "member", "dead", "rng")

    def __init__(self, req: DecodeRequest, pages: List[int], ctx_len: int,
                 group: Optional["_BeamGroup"] = None, member: int = 0):
        self.req = req
        self.pages = pages
        self.ctx_len = int(ctx_len)
        self.new_tokens = 0
        self.group = group
        self.member = member
        self.dead = False               # beam member frozen (score kept)
        self.rng = (np.random.default_rng(req.seed)
                    if req.temperature else None)


class _BeamGroup:
    """Host-side beam state shared by k sibling slots (one request)."""

    __slots__ = ("req", "slot_idx", "k", "scores", "alive", "seqs",
                 "selects")

    def __init__(self, req: BeamRequest, slot_idx: List[int]):
        self.req = req
        self.slot_idx = slot_idx
        self.k = req.beam_size
        self.scores = np.full((self.k,), -np.inf, np.float32)
        self.scores[0] = 0.0            # identical beams start as one
        self.alive = np.ones((self.k,), bool)
        self.seqs: List[List[int]] = [[] for _ in range(self.k)]
        self.selects = 0                # beam_select calls consumed


class DecodeSession:
    """Token-granularity continuous batching over a paged model.

    ``model`` contract (duck-typed; see model.TinyDecoderLM):

    - ``allocator``/``page_size``/``pages_per_seq``: paging geometry
    - ``bos_id``/``eos_id``: token conventions
    - ``grows_kv``: True when each decode step appends one KV row
      (transformer self-attention) — the session then reserves pages
      for prompt+budget at admission and advances lengths per step
    - ``context_pages(prompt, max_new) -> int``: pages to reserve
    - ``prefill(prompt, pages) -> (ctx_len, state_rows, first_logits)``
      where ``state_rows`` is one row per state buffer and
      ``first_logits`` (or None) scores the first generated token
    - ``state_specs -> [(row_shape, dtype), ...]``
    - ``decode(tokens (S,1), states, page_tables (S,P), lens (S,))
      -> (logits (S,V), new_states)``

    Sharing extensions (all optional, duck-typed):

    - ``copy_page(src, dst)``: device copy of one page — required for
      copy-on-write splits (beam forks / prefix-cache donors)
    - ``supports_prefix_cache`` + ``prefill(..., cached_len=)``: resume
      a prefill after ``cached_len`` rows already paged by the cache
    - ``verify_chunk(tokens (S,k), states, tables, lens) -> (logits
      (S,k,V), new_states)``: score k tokens per slot in one step —
      enables speculative decoding
    - ``emits_probs``: decode returns distributions, not raw logits
      (affects sampling/beam log-prob handling)
    """

    def __init__(self, model, max_slots: int = 8,
                 max_waiting: Optional[int] = None,
                 prefix_cache=None, spec_draft=None, spec_k: int = 4):
        self.model = model
        self.max_slots = int(max_slots)
        self.max_waiting = max_waiting
        # prefix cache: only meaningful when the model can resume a
        # prefill mid-prompt (supports_prefix_cache)
        self._prefix = (prefix_cache
                        if getattr(model, "supports_prefix_cache", False)
                        else None)
        # speculative mode: draft proposes spec_k - 1 tokens, the model
        # verifies the whole chunk in one step (needs verify_chunk)
        self._spec_draft = (spec_draft
                            if hasattr(model, "verify_chunk")
                            and getattr(model, "grows_kv", False)
                            else None)
        self.spec_k = int(spec_k)
        if self._spec_draft is not None and self.spec_k < 2:
            raise ValueError("speculative decoding needs spec_k >= 2")
        self._lock = threading.Lock()
        self._pending: List[DecodeRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        S = self.max_slots
        P = model.pages_per_seq
        self._tokens = np.full((S, 1), model.bos_id, np.int64)
        self._tables = np.full((S, P), 0, np.int32)   # null page
        self._lens = np.ones((S,), np.int64)
        self._states = [np.zeros((S,) + tuple(shape), dtype)
                        for shape, dtype in model.state_specs]

    @property
    def prefix_cache(self):
        return self._prefix

    # -- submission ---------------------------------------------------------

    def submit(self, req: DecodeRequest) -> DecodeRequest:
        """Queue a request; raises AdmissionRefused when it can never
        run (too long for the pool) or the wait queue is full."""
        if self._spec_draft is not None and (
                req.temperature or isinstance(req, BeamRequest)):
            _M_REFUSED.inc(reason="spec_mode")
            raise AdmissionRefused(
                "spec_mode", "a speculative session verifies greedy "
                "chunks; sampling and beam search are not available")
        if isinstance(req, BeamRequest) and req.beam_size > self.max_slots:
            _M_REFUSED.inc(reason="beam_too_wide")
            raise AdmissionRefused(
                "beam_too_wide",
                f"beam_size {req.beam_size} exceeds the session's "
                f"{self.max_slots} slots")
        need = self.model.context_pages(req.prompt, req.max_new_tokens)
        usable = self.model.allocator.num_pages - 1
        if need > min(usable, self.model.pages_per_seq):
            _M_REFUSED.inc(reason="too_long")
            raise AdmissionRefused(
                "too_long",
                f"request needs {need} pages; a sequence may hold at most "
                f"{min(usable, self.model.pages_per_seq)}")
        with self._lock:
            if (self.max_waiting is not None
                    and len(self._pending) >= self.max_waiting):
                _M_REFUSED.inc(reason="queue_full")
                raise AdmissionRefused(
                    "queue_full",
                    f"admission queue is full ({self.max_waiting} waiting)")
            self._pending.append(req)
            _M_WAITING.set(len(self._pending))
        return req

    # -- introspection ------------------------------------------------------

    @property
    def active(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s is not None)

    @property
    def waiting(self) -> int:
        with self._lock:
            return len(self._pending)

    def idle(self) -> bool:
        with self._lock:
            return not self._pending and all(s is None
                                             for s in self._slots)

    # -- scheduler tick -----------------------------------------------------

    def step(self) -> int:
        """One tick: admit -> decode -> evict.  Returns the number of
        slots that were active during the decode dispatch (0 = idle,
        nothing dispatched).  A decode dispatch that *raises* is
        contained (``_contain_step_failure``): the slots that were in
        the batch are evicted — first offense requeued to retry from
        scratch, second offense quarantined with 503 ``step_failed`` —
        and the stepper thread lives on."""
        self._sweep_cancelled()
        self._admit()
        active_idx = [i for i, s in enumerate(self._slots) if s is not None]
        if not active_idx:
            return 0
        if self._spec_draft is not None and self._spec_ready(active_idx):
            return self._spec_step(active_idx)
        if self.model.grows_kv:
            # the step writes each live slot's next KV row: split any
            # page shared with a fork / the prefix cache first
            for i in active_idx:
                if (self._slots[i] is not None
                        and not self._slots[i].dead):
                    self._ensure_private(i, rows=1)
            active_idx = [i for i in active_idx
                          if self._slots[i] is not None]
            if not active_idx:
                return 0
        t0 = time.perf_counter()
        try:
            logits, new_states = self.model.decode(
                self._tokens, self._states, self._tables, self._lens)
        except BaseException as exc:  # noqa: BLE001 - contained per slot
            self._contain_step_failure(active_idx, exc)
            return len(active_idx)
        _M_STEP_SEC.observe(time.perf_counter() - t0)
        _M_STEPS.inc()
        logits = np.asarray(logits)
        for i, buf in enumerate(self._states):
            buf[...] = np.asarray(new_states[i])
        if self.model.grows_kv:
            for i in active_idx:
                if not self._slots[i].dead:
                    self._slots[i].ctx_len += 1
                    self._lens[i] = self._slots[i].ctx_len
        now = time.monotonic()
        groups_seen = set()
        for i in active_idx:
            slot = self._slots[i]
            if slot is None:
                continue
            if slot.group is not None:
                g = slot.group
                if id(g) in groups_seen:
                    continue
                groups_seen.add(id(g))
                if g.req.expired(now):
                    self._finish_group(g, "deadline", TimeoutError(
                        "generation deadline expired"))
                    continue
                self._group_select(
                    g, logits[np.asarray(g.slot_idx, np.intp)])
                continue
            if slot.req.expired(now):
                self._evict(i, "deadline",
                            TimeoutError("generation deadline expired"))
                continue
            tok = self._choose(slot, logits[i])
            self._emit_token(i, tok)
        _M_ACTIVE.set(self.active)
        return len(active_idx)

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive the session until every queued request finishes (the
        offline / benchmark entry; serving uses a background thread
        around ``step``)."""
        steps = 0
        while not self.idle():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"decode loop did not drain in {max_steps} steps")

    # -- internals ----------------------------------------------------------

    def _choose(self, slot: _Slot, row: np.ndarray) -> int:
        """Next token for one slot: argmax unless the request opted
        into sampling (temperature/top_k under the slot's seeded RNG)."""
        req = slot.req
        if not req.temperature:
            return int(np.argmax(row))
        row = np.asarray(row, np.float64).reshape(-1)
        if getattr(self.model, "emits_probs", False):
            logp = np.log(np.maximum(row, 1e-20))
        else:
            logp = row - row.max()
            logp = logp - np.log(np.exp(logp).sum())
        logp = logp / req.temperature
        if req.top_k and req.top_k < logp.size:
            kth = np.partition(logp, -req.top_k)[-req.top_k]
            logp = np.where(logp >= kth, logp, -np.inf)
        p = np.exp(logp - logp.max())
        p = p / p.sum()
        return int(slot.rng.choice(p.size, p=p))

    def _ensure_private(self, i: int, rows: int) -> bool:
        """Copy-on-write gate before the decode step appends ``rows``
        KV rows to slot ``i``: any owned page those rows land in that is
        still shared (beam sibling, prefix cache) gets split to a
        private copy.  On pool exhaustion the prefix cache gives pages
        back first; failing that the slot (or its whole beam group) is
        evicted.  Returns False when the slot was evicted."""
        slot = self._slots[i]
        ps = self.model.page_size
        alloc = self.model.allocator
        first = slot.ctx_len // ps
        last = min((slot.ctx_len + rows - 1) // ps, len(slot.pages) - 1)
        changed = False
        for pi in range(first, last + 1):
            while alloc.is_shared(slot.pages[pi]):
                try:
                    cow_split(alloc, slot.pages, pi,
                              [self.model.copy_page])
                    changed = True
                except PoolExhausted:
                    if (self._prefix is not None
                            and self._prefix.evict_for_pages(1)):
                        continue
                    err = AdmissionRefused(
                        "pool_exhausted",
                        "no free page for a copy-on-write split")
                    if slot.group is not None:
                        self._finish_group(slot.group, "error", err)
                    else:
                        self._evict(i, "error", err)
                    return False
        if changed:
            self._tables[i] = self.model.pool_table(slot.pages)
        return True

    # -- beam groups --------------------------------------------------------

    def _group_select(self, g: _BeamGroup, dist: np.ndarray) -> None:
        """One beam bookkeeping step for a group: run the shared oracle
        selection over the members' distributions, then reorder the
        sibling slots — each surviving hypothesis forks its parent's
        pages (CoW) and inherits its states; dropped hypotheses release
        theirs."""
        dist = np.asarray(dist, np.float64)
        if not getattr(self.model, "emits_probs", False):
            # beam_select scores log-probabilities: raw logits must be
            # softmaxed per row first (mirrors _choose), or every
            # negative logit clamps to the same log floor and the
            # rankings are garbage
            dist = dist - dist.max(axis=-1, keepdims=True)
            dist = np.exp(dist)
            dist = dist / dist.sum(axis=-1, keepdims=True)
        sel = beam_select(dist, g.scores,
                          g.alive, g.seqs, self.model.eos_id, g.k)
        if sel is None:
            self._finish_group(g, "eos")
            return
        g.scores, g.seqs, g.alive, rows, toks = sel
        g.selects += 1
        _M_TOKENS.inc(int(g.alive.sum()))
        slots = [self._slots[si] for si in g.slot_idx]
        old_pages = [s.pages for s in slots]
        ctx_snap = [s.ctx_len for s in slots]
        state_snap = [buf[np.asarray(g.slot_idx, np.intp)].copy()
                      for buf in self._states]
        alloc = self.model.allocator
        # fork every survivor's parent pages BEFORE releasing anything:
        # fork only bumps refcounts, so this can never exhaust the pool
        new_pages = [alloc.fork(old_pages[rows[j]]) if g.alive[j] else []
                     for j in range(g.k)]
        for pages in old_pages:
            if pages:
                alloc.free(pages)
        for j, si in enumerate(g.slot_idx):
            slot = slots[j]
            slot.pages = new_pages[j]
            slot.dead = not bool(g.alive[j])
            if slot.dead:
                slot.ctx_len = 1
                self._tables[si] = 0
                self._lens[si] = 1
                self._tokens[si, 0] = self.model.eos_id
            else:
                slot.ctx_len = ctx_snap[rows[j]]
                self._tables[si] = self.model.pool_table(slot.pages)
                self._lens[si] = slot.ctx_len
                self._tokens[si, 0] = toks[j]
            for bi, buf in enumerate(self._states):
                buf[si] = state_snap[bi][rows[j]]
        if not g.alive.any() or g.selects >= g.req.max_new_tokens:
            self._finish_group(g, "eos" if not g.alive.any() else "length")

    def _finish_group(self, g: _BeamGroup, reason: str,
                      error: Optional[BaseException] = None) -> None:
        for si in g.slot_idx:
            slot = self._slots[si]
            if slot is None:
                continue
            self._slots[si] = None
            self._tables[si] = 0
            self._lens[si] = 1
            self._tokens[si, 0] = self.model.bos_id
            if slot.pages:
                self.model.allocator.free(slot.pages)
                slot.pages = []
        if error is None:
            order = np.argsort(-g.scores)
            g.req.beams = [(float(g.scores[i]), list(g.seqs[i]))
                           for i in order if np.isfinite(g.scores[i])]
            g.req.tokens = (list(g.req.beams[0][1])
                            if g.req.beams else [])
        g.req._finish(reason, error)
        _M_ACTIVE.set(self.active)

    # -- speculative decoding -----------------------------------------------

    def _spec_ready(self, active_idx: List[int]) -> bool:
        """The whole tick runs one (S, k) verify chunk only when every
        live slot has k rows of page capacity left; otherwise this tick
        falls back to the plain one-token step (fixed shapes both
        ways)."""
        k = self.spec_k
        cap = self.model.page_size * self.model.pages_per_seq
        if 1 + k >= cap:
            return False
        for i in active_idx:
            slot = self._slots[i]
            if slot.ctx_len + k > len(slot.pages) * self.model.page_size:
                return False
        return True

    def _spec_step(self, active_idx: List[int]) -> int:
        """One speculative tick: the draft proposes k-1 tokens per live
        slot, one chunked verify step scores all of them, and each slot
        emits the accepted prefix + the target's correction token —
        token-identical to the greedy path.  Rejected rows stay in the
        pages but ``lens`` never reaches them (rollback = truncation)."""
        k = self.spec_k
        S = self.max_slots
        tokens = np.full((S, k), self.model.bos_id, np.int64)
        drafts = {}
        for i in list(active_idx):
            slot = self._slots[i]
            if not self._ensure_private(i, rows=k):
                continue
            ids = [int(t) for t in slot.req.prompt] + slot.req.tokens
            d = [int(t) for t in self._spec_draft.propose(ids, k - 1)]
            drafts[i] = d
            tokens[i, 0] = self._tokens[i, 0]
            tokens[i, 1:] = d
        active_idx = [i for i in active_idx if i in drafts]
        if not active_idx:
            return 0
        t0 = time.perf_counter()
        try:
            logits, new_states = self.model.verify_chunk(
                tokens, self._states, self._tables, self._lens)
        except BaseException as exc:  # noqa: BLE001 - contained per slot
            self._contain_step_failure(active_idx, exc)
            return len(active_idx)
        _M_STEP_SEC.observe(time.perf_counter() - t0)
        _M_STEPS.inc()
        logits = np.asarray(logits)                     # (S, k, V)
        for i, buf in enumerate(self._states):
            if new_states:
                buf[...] = np.asarray(new_states[i])
        now = time.monotonic()
        for i in active_idx:
            slot = self._slots[i]
            if slot.req.expired(now):
                self._evict(i, "deadline",
                            TimeoutError("generation deadline expired"))
                continue
            target = np.argmax(logits[i], axis=-1)      # (k,)
            emitted, accepted = accept_greedy(drafts[i], target)
            observe_chunk(k - 1, accepted, k)
            # rows of [prev] + accepted drafts are real; later rows are
            # speculative garbage the length mask never reaches
            slot.ctx_len += 1 + accepted
            self._lens[i] = slot.ctx_len
            for tok in emitted:
                self._emit_token(i, tok)
                if self._slots[i] is not slot:          # eos / budget
                    break
        _M_ACTIVE.set(self.active)
        return len(active_idx)

    def _emit_token(self, i: int, tok: int) -> None:
        slot = self._slots[i]
        slot.req._emit(tok)
        slot.new_tokens += 1
        _M_TOKENS.inc()
        if tok == self.model.eos_id:
            self._evict(i, "eos")
        elif slot.new_tokens >= slot.req.max_new_tokens:
            self._evict(i, "length")
        else:
            self._tokens[i, 0] = tok

    def _contain_step_failure(self, active_idx: List[int],
                              exc: BaseException) -> None:
        """A decode/verify dispatch raised.  One fused step covers every
        live slot, so the offender can't be attributed from here — every
        slot that was in the batch is a suspect.  First offense: the
        slot is evicted and its request requeued to retry from a fresh
        prefill (innocent batchmates lose only latency).  Second
        offense: the request has now killed two dispatches and is
        quarantined with 503 ``step_failed`` — the decode-plane mirror
        of the replica pool's poison-batch rule.  Queued requests and
        the stepper thread are untouched."""
        _M_STEP_FAIL.inc()
        requeue: List[DecodeRequest] = []
        groups_seen = set()
        for i in list(active_idx):
            slot = self._slots[i]
            if slot is None:
                continue
            if slot.group is not None:
                g = slot.group
                if id(g) in groups_seen:
                    continue
                groups_seen.add(id(g))
                # beam hypotheses share one request: no per-member
                # retry semantics, the group fails as a unit
                self._finish_group(g, "error", AdmissionRefused(
                    "step_failed",
                    f"decode step failed with this beam in the batch: "
                    f"{type(exc).__name__}: {exc}"))
                continue
            req = slot.req
            req.step_failures += 1
            if req.step_failures >= 2:
                self._evict(i, "error", AdmissionRefused(
                    "step_failed",
                    f"decode step failed {req.step_failures} times with "
                    f"this request in the batch; quarantined "
                    f"({type(exc).__name__}: {exc})"))
                continue
            # evict without finishing: the request restarts from an
            # empty generation at its next admission
            self._slots[i] = None
            self._tables[i] = 0
            self._lens[i] = 1
            self._tokens[i, 0] = self.model.bos_id
            if slot.pages:
                self.model.allocator.free(slot.pages)
                slot.pages = []
            req.tokens = []
            requeue.append(req)
        if requeue:
            with self._lock:
                self._pending[0:0] = requeue
                _M_WAITING.set(len(self._pending))
        _M_ACTIVE.set(self.active)

    def _sweep_cancelled(self) -> None:
        """Evict slots whose consumer abandoned them (dead streaming
        socket) and drop cancelled waiters — pages and queue capacity
        come back immediately instead of after max_new_tokens."""
        for i, slot in enumerate(self._slots):
            if (slot is not None and slot.req.cancelled
                    and not slot.req.done):
                _M_CANCELLED.inc()
                self._evict(i, "cancelled")
        with self._lock:
            live, dead = [], []
            for req in self._pending:
                (dead if req.cancelled else live).append(req)
            if dead:
                self._pending = live
                _M_WAITING.set(len(live))
        for req in dead:
            _M_CANCELLED.inc()
            req._finish("cancelled")

    def _sweep_expired(self) -> None:
        """Fail queued requests whose deadline passed.  Runs every tick
        — even with zero free slots — so dead waiters release their
        max_waiting capacity instead of causing spurious queue_full
        refusals while they wait for an eviction."""
        now = time.monotonic()
        with self._lock:
            live, dead = [], []
            for req in self._pending:
                (dead if req.expired(now) else live).append(req)
            self._pending = live
            _M_WAITING.set(len(live))
        for req in dead:
            req._finish("deadline", TimeoutError(
                "generation deadline expired while queued"))

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _requeue_head(self, req: DecodeRequest) -> None:
        # pages/slots are busy with live sequences: requeue at the head
        # — an evict next tick frees them.  Not a refusal; refusal
        # happens at submit (never fits / queue full).
        with self._lock:
            self._pending.insert(0, req)
            _M_WAITING.set(len(self._pending))

    def _prefill_with_cache(self, req: DecodeRequest, need: int):
        """Allocate + prefill one prompt, reusing cached prefix pages
        when the cache has them.  Returns (pages, ctx_len, state_rows,
        first_logits) or None when the pool cannot host the fresh part
        right now (caller requeues).  Exceptions propagate with nothing
        left allocated."""
        alloc = self.model.allocator
        cached_pages: List[int] = []
        cached_len = 0
        if self._prefix is not None:
            cached_pages, cached_len = self._prefix.match(req.prompt)
        fresh_need = need - len(cached_pages)
        if not alloc.can_alloc(fresh_need):
            if self._prefix is not None:
                self._prefix.evict_for_pages(
                    fresh_need - alloc.free_pages)
            if not alloc.can_alloc(fresh_need):
                if cached_pages:
                    alloc.free(cached_pages)
                return None
        t0 = time.perf_counter()
        pages = cached_pages + alloc.alloc(fresh_need)
        try:
            if cached_len:
                ctx_len, state_rows, first_logits = self.model.prefill(
                    req.prompt, pages, cached_len=cached_len)
            else:
                ctx_len, state_rows, first_logits = self.model.prefill(
                    req.prompt, pages)
        except BaseException:
            alloc.free(pages)
            raise
        _M_PREFILL_SEC.observe(time.perf_counter() - t0)
        if self._prefix is not None:
            # stats only count now that the admission committed — a
            # requeued request re-matches every retry and must not
            # inflate hits/tokens_saved for prefills that never ran
            self._prefix.commit_match(cached_len)
            self._prefix.insert(req.prompt, pages)
        return pages, ctx_len, state_rows, first_logits

    def _place(self, i: int, slot: _Slot, ctx_len: int,
               state_rows) -> None:
        self._slots[i] = slot
        self._tables[i] = self.model.pool_table(slot.pages)
        self._lens[i] = ctx_len
        self._tokens[i, 0] = self.model.bos_id
        for buf, row in zip(self._states, state_rows):
            buf[i] = row

    def _admit(self) -> None:
        self._sweep_expired()
        while True:
            frees = self._free_slots()
            if not frees:
                return
            with self._lock:
                req = self._pending.pop(0) if self._pending else None
                _M_WAITING.set(len(self._pending))
            if req is None:
                return
            if isinstance(req, BeamRequest):
                if len(frees) < req.beam_size:
                    self._requeue_head(req)
                    return
            need = self.model.context_pages(req.prompt, req.max_new_tokens)
            try:
                got = self._prefill_with_cache(req, need)
                if got is None:
                    self._requeue_head(req)
                    return
                pages, ctx_len, state_rows, first_logits = got
            except PoolExhausted as e:   # raced with another allocator user
                _M_REFUSED.inc(reason="pool_exhausted")
                req._finish("error", AdmissionRefused("pool_exhausted",
                                                      str(e)))
                continue
            except BaseException as e:
                req._finish("error", e)
                continue
            if isinstance(req, BeamRequest):
                self._admit_beam(req, frees[:req.beam_size], pages,
                                 ctx_len, state_rows, first_logits)
            else:
                self._place(frees[0], _Slot(req, pages, ctx_len),
                            ctx_len, state_rows)
                if first_logits is not None:
                    slot = self._slots[frees[0]]
                    tok = self._choose(slot,
                                       np.asarray(first_logits))
                    self._emit_token(frees[0], tok)
            _M_ACTIVE.set(self.active)

    def _admit_beam(self, req: BeamRequest, slot_idx: List[int],
                    pages: List[int], ctx_len: int, state_rows,
                    first_logits) -> None:
        """Seat one beam group: the prefilled prompt pages back member
        0; every sibling *forks* them (refcount bump, zero copies) and
        diverges later through copy-on-write writes."""
        g = _BeamGroup(req, slot_idx)
        alloc = self.model.allocator
        for j, si in enumerate(slot_idx):
            member_pages = pages if j == 0 else alloc.fork(pages)
            self._place(si, _Slot(req, member_pages, ctx_len,
                                  group=g, member=j),
                        ctx_len, state_rows)
        if first_logits is not None:
            # the prompt's own logits drive the first selection (all
            # members share them; dead starting scores mask duplicates)
            row = np.asarray(first_logits).reshape(1, -1)
            self._group_select(g, np.repeat(row, g.k, axis=0))

    def _evict(self, i: int, reason: str,
               error: Optional[BaseException] = None) -> None:
        slot = self._slots[i]
        if slot is not None and slot.group is not None:
            # a beam member never leaves alone: the hypotheses share
            # one request, so the whole group goes
            self._finish_group(slot.group, reason, error)
            return
        self._slots[i] = None
        self._tables[i] = 0
        self._lens[i] = 1
        self._tokens[i, 0] = self.model.bos_id
        if slot.pages:
            self.model.allocator.free(slot.pages)
            slot.pages = []
        slot.req._finish(reason, error)

    def fail_all(self, exc: BaseException) -> None:
        """Shutdown: fail every live and queued request."""
        with self._lock:
            pending, self._pending = self._pending, []
        for req in pending:
            req._finish("error", exc)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._evict(i, "error", exc)
