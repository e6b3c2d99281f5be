"""PagedSeq2SeqModel: a v1 ``beam_search`` spec as a paged decode model
(``paddle_tpu/decode/seq2seq.py``).

``SequenceGenerator`` (``generation.py``) runs ONE program that re-runs
the encoder every decode step and serves one sequence at a time: the
dense oracle.  This adapter splits the same spec into the prefill and
decode pair the session schedules:

- **prefill program**: the encoder alone, ``src`` in, the padded encoder
  states (and the memories' boot values) out.  Run once per admitted
  sequence; its states are written into the sequence's pages on the
  device, with no round trip through the host.
- **decode program**: the decoder step rebuilt around the paged
  context: the whole page pool (``@dec_pool``, the pool's own device
  tensor), the per-slot page tables and the true lengths are feeds; a
  ``gather`` assembles each slot's padded context ``(slots,
  pages_per_seq * page_size, hid)`` and the padded-sequence attention
  masks by length.  Its shapes depend only on the session's geometry,
  never on which sequences are in the batch, so the Executor plans it
  once.

The paged replies equal the oracle's token for token because both feed
the feeder's identically padded encoder states through the same ops
with the same length masks.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.decode.paged_kv import PagedPool


class PagedSeq2SeqModel:
    """Adapt ``BeamGen`` + trained parameters to the DecodeSession, on
    ``place`` (``CUDAPlace(0)`` unless the caller passes another)."""

    grows_kv = False          # cross-attention context is static
    emits_probs = True        # the step program ends in softmax

    def __init__(self, beam_gen, parameters, *, num_pages: int = 64,
                 page_size: int = 8, pages_per_seq: int = 2,
                 place=None):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch import layers as L
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.generation import (build_boot_vars,
                                                 resolve_new_state_vars,
                                                 run_startup_for_missing)
        from paddle_tpu_torch.layer_helper import LayerHelper
        from paddle_tpu_torch.param_attr import ParamAttr
        from paddle_tpu_torch.v2.layer import SeqVal
        from paddle_tpu_torch.v2.topology import normalize_feeds
        from paddle_tpu_torch.v2.trainer import V2DataFeeder

        self._exe = Executor(place)
        self.place = self._exe.place
        self.device = self._exe.device
        self.bg = beam_gen
        self.bos_id = beam_gen.bos_id
        self.eos_id = beam_gen.eos_id
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.ctx_cap = self.page_size * self.pages_per_seq
        hid = beam_gen.static_ins[0].size
        self.pool = PagedPool(num_pages, page_size, (hid,), torch.float32,
                              device=self.device)
        self.allocator = self.pool.allocator
        self._scope = parameters.scope

        # -- prefill program: encoder -> padded states + boots ----------
        self._prefill_main = framework.Program()
        prefill_startup = framework.Program()
        with framework.program_guard(self._prefill_main, prefill_startup):
            ctx: dict = {}
            static_vals = [s.input.build(ctx) for s in beam_gen.static_ins]
            self._feed_types = normalize_feeds(ctx.get("@feeds", []))
            self._feeder = V2DataFeeder(self._feed_types)
            enc = static_vals[0]
            if not isinstance(enc, SeqVal):
                raise TypeError("paged decode needs a sequence StaticInput "
                                "(is_seq=True) as the attention context")
            self._enc_var = enc.var
            self._boot_vars = build_boot_vars(beam_gen, ctx)

        # -- decode program: step over the paged context ----------------
        self._step_main = framework.Program()
        step_startup = framework.Program()
        with framework.program_guard(self._step_main, step_startup):
            sub_ctx: dict = {}
            word = L.data(name="@dec_word", shape=[-1, 1], dtype="int64",
                          append_batch_size=False)
            emb = L.embedding(
                word, size=[beam_gen.gen.size, beam_gen.gen.embedding_size],
                param_attr=ParamAttr(name=beam_gen.gen.embedding_name))
            emb = L.reshape(emb, [-1, beam_gen.gen.embedding_size])
            sub_ctx[id(beam_gen._word_ph)] = emb

            pool_var = L.data(name="@dec_pool",
                              shape=[self.pool.num_pages, page_size, hid],
                              dtype="float32", append_batch_size=False)
            ptab = L.data(name="@dec_ptab", shape=[-1, self.pages_per_seq],
                          dtype="int64", append_batch_size=False)
            lens = L.data(name="@dec_ctx_len", shape=[-1], dtype="int64",
                          append_batch_size=False)
            flat = L.reshape(ptab, [-1])
            helper = LayerHelper("gather")
            gathered = helper.create_tmp_variable(dtype="float32")
            helper.append_op(type="gather",
                             inputs={"X": [pool_var], "Index": [flat]},
                             outputs={"Out": [gathered]})
            ctx_var = L.reshape(gathered, [-1, self.ctx_cap, hid])
            sub_ctx[id(beam_gen._static_phs[0])] = SeqVal(ctx_var, lens)

            self._state_names: List[str] = []
            self._state_sizes: List[int] = []
            for i, m in enumerate(beam_gen.memories):
                sname = f"@dec_state_{i}"
                sv = L.data(name=sname, shape=[-1, m.size], dtype="float32",
                            append_batch_size=False)
                self._state_names.append(sname)
                self._state_sizes.append(m.size)
                sub_ctx[id(m)] = sv
            out = beam_gen.step_out.build(sub_ctx)
            self._probs_var = out.var if isinstance(out, SeqVal) else out
            self._new_state_vars = resolve_new_state_vars(beam_gen, sub_ctx)

        run_startup_for_missing(self._exe, self._scope,
                                prefill_startup, step_startup)

    # -- session contract ---------------------------------------------------

    @property
    def state_specs(self) -> List[Tuple[tuple, Any]]:
        return [((size,), np.float32) for size in self._state_sizes]

    def context_pages(self, prompt, max_new_tokens: int) -> int:
        # static context: pages cover the feeder-padded encoder length
        # (max_new_tokens is irrelevant: nothing grows)
        t = self._padded_len(prompt)
        return self.pool.pages_for(t)

    def pool_table(self, pages: Sequence[int]) -> np.ndarray:
        return self.pool.page_table(pages, self.pages_per_seq)

    def copy_page(self, src: int, dst: int) -> None:
        # static context is never written after prefill, so beams share
        # encoder pages forever; the hook exists for the contract
        self.pool.copy_page(src, dst)

    def _padded_len(self, prompt) -> int:
        bucket = self._feeder.time_bucket
        return max(1, -(-len(prompt[0]) // bucket)) * bucket

    def prefill(self, prompt, pages: Sequence[int]):
        """Run the encoder for one prompt row and page its states."""
        base = self._feeder.feed([prompt]) if self._feed_types else {}
        fetch = [self._enc_var] + [v for v in self._boot_vars
                                   if v is not None]
        # scope passed explicitly: scope_guard would mutate the
        # process-global scope stack from the session stepper thread;
        # the states stay on the device, the pool's
        outs = self._exe.run(self._prefill_main, feed=dict(base),
                             fetch_list=fetch, scope=self._scope,
                             return_numpy=False)
        # page the feeder-padded rows verbatim: the oracle's attention
        # sees exactly these rows under the same length mask
        self.pool.write_rows(pages, outs[0][0])     # (T_padded, hid)
        boots = iter(outs[1:])
        state_rows = []
        for m, bv in zip(self.bg.memories, self._boot_vars):
            if bv is None:
                state_rows.append(np.zeros((m.size,), np.float32))
            else:
                state_rows.append(next(boots).detach().reshape(-1).float()
                                  .cpu().numpy())
        return len(prompt[0]), state_rows, None

    def decode(self, tokens: np.ndarray, states: List[np.ndarray],
               tables: np.ndarray, lens: np.ndarray):
        """One fixed-shape decode step over every slot."""
        feed = {"@dec_word": tokens, "@dec_pool": self.pool.data,
                "@dec_ptab": tables.astype(np.int64),
                "@dec_ctx_len": lens}
        for name, buf in zip(self._state_names, states):
            feed[name] = buf
        outs = self._exe.run(
            self._step_main, feed=feed,
            fetch_list=[self._probs_var] + self._new_state_vars,
            scope=self._scope)
        probs = np.asarray(outs[0]).reshape(tokens.shape[0], -1)
        return probs, [np.asarray(o) for o in outs[1:]]
