"""GenerationEngine: the serving front over a DecodeSession
(``paddle_tpu/decode/engine.py``).

One background stepper thread drives the session's admit->decode->evict
tick whenever work exists; HTTP handler threads submit requests and
stream tokens through per-request callbacks.  Admission refusals
(``AdmissionRefused``: pool can never fit the request, or the wait
queue is full) surface to the caller — serving maps them to 503, and a
request deadline to 504, through the same shedding conventions as
``/predict``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

from paddle_tpu_torch.decode.session import (
    AdmissionRefused,
    BeamRequest,
    DecodeRequest,
    DecodeSession,
)

__all__ = ["AdmissionRefused", "BeamRequest", "DecodeRequest",
           "GenerationEngine"]


class GenerationEngine:
    def __init__(self, model, max_slots: int = 8,
                 max_waiting: Optional[int] = 64,
                 max_new_tokens: int = 32,
                 prompt_of: Optional[Callable] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 spec_draft=None, spec_k: int = 4,
                 beam_max: int = 0):
        self.model = model
        cache = None
        if prefix_cache and getattr(model, "supports_prefix_cache", False):
            from paddle_tpu_torch.decode.prefix import PrefixCache

            cache = PrefixCache(model.allocator, model.page_size,
                                capacity_pages=prefix_cache_pages)
        self.session = DecodeSession(model, max_slots=max_slots,
                                     max_waiting=max_waiting,
                                     prefix_cache=cache,
                                     spec_draft=spec_draft, spec_k=spec_k)
        self.beam_max = int(beam_max)
        self.max_new_tokens_cap = int(max_new_tokens)
        # identity by default: most models (TinyDecoderLM) take the id
        # list as-is; for_seq2seq wraps it as a v2 reader row
        self._prompt_of = prompt_of or (lambda ids: ids)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._stepper, daemon=True,
                                        name="decode-stepper")
        self._thread.start()

    @classmethod
    def for_seq2seq(cls, beam_gen, parameters, *, num_pages: int = 64,
                    page_size: int = 8, pages_per_seq: int = 2,
                    max_slots: int = 8, max_waiting: Optional[int] = 64,
                    max_new_tokens: Optional[int] = None,
                    beam_max: int = 0,
                    place=None) -> "GenerationEngine":
        """An engine over a v1 ``beam_search`` spec
        (``PagedSeq2SeqModel``) on ``place`` (``CUDAPlace(0)`` unless the
        caller passes another); ``max_new_tokens`` defaults to the spec's
        ``max_length``."""
        from paddle_tpu_torch.decode.seq2seq import PagedSeq2SeqModel

        model = PagedSeq2SeqModel(beam_gen, parameters,
                                  num_pages=num_pages, page_size=page_size,
                                  pages_per_seq=pages_per_seq, place=place)
        return cls(model, max_slots=max_slots, max_waiting=max_waiting,
                   max_new_tokens=(max_new_tokens
                                   if max_new_tokens is not None
                                   else beam_gen.max_length),
                   beam_max=beam_max,
                   prompt_of=lambda ids: [ids])

    # -- submission ---------------------------------------------------------

    def _budget(self, max_new_tokens: Optional[int]) -> int:
        budget = self.max_new_tokens_cap
        if max_new_tokens is not None:
            budget = max(1, min(int(max_new_tokens), budget))
        return budget

    def submit(self, src_ids: List[int],
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               deadline: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None) -> DecodeRequest:
        """Queue a generation request.  Raises AdmissionRefused when the
        engine cannot take it (503-shaped), otherwise returns the
        request handle — ``wait()``/``result()`` or stream via
        ``on_token``.  ``temperature``/``top_k``/``seed`` switch the
        slot from greedy argmax to seeded sampling."""
        req = DecodeRequest(self._prompt_of(list(src_ids)),
                            max_new_tokens=self._budget(max_new_tokens),
                            on_token=on_token, deadline=deadline,
                            temperature=temperature, top_k=top_k,
                            seed=seed)
        self.session.submit(req)
        self._wake.set()
        return req

    def submit_beam(self, src_ids: List[int], beam_size: int,
                    max_new_tokens: Optional[int] = None,
                    deadline: Optional[float] = None) -> BeamRequest:
        """Queue a beam-search request (k sibling slots sharing the
        prompt's pages copy-on-write).  Refused when beam search is
        disabled (``beam_max`` 0) or wider than the configured cap."""
        if beam_size > self.beam_max:
            raise AdmissionRefused(
                "beam_disabled" if self.beam_max == 0 else "beam_too_wide",
                f"beam_size {beam_size} exceeds the engine cap "
                f"({self.beam_max})")
        req = BeamRequest(self._prompt_of(list(src_ids)),
                          beam_size=beam_size,
                          max_new_tokens=self._budget(max_new_tokens),
                          deadline=deadline)
        self.session.submit(req)
        self._wake.set()
        return req

    def cancel(self, req: DecodeRequest) -> None:
        """Abandon a request whose consumer is gone (dead streaming
        socket): flags it and nudges the stepper, which evicts the slot
        and frees its pages at the next tick."""
        req.cancel()
        self._wake.set()

    # -- introspection ------------------------------------------------------

    def info(self) -> dict:
        alloc = self.model.allocator
        out = {
            "slots": self.session.max_slots,
            "active": self.session.active,
            "waiting": self.session.waiting,
            "page_size": self.model.page_size,
            "pages_total": alloc.num_pages - 1,   # page 0 reserved
            "pages_free": alloc.free_pages,
            "pages_shared": alloc.pages_shared,
            "max_new_tokens": self.max_new_tokens_cap,
            "bos_id": self.model.bos_id,
            "eos_id": self.model.eos_id,
            "beam_max": self.beam_max,
            "speculative": self.session._spec_draft is not None,
        }
        cache = self.session.prefix_cache
        if cache is not None:
            out["prefix_cache"] = cache.stats()
        return out

    # -- lifecycle ----------------------------------------------------------

    def _stepper(self) -> None:
        # the model's device, explicitly: this thread runs every step's
        # CUDA work, and the current device is per thread
        device = getattr(self.model, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            if self.session.idle():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self.session.step()
            except BaseException as exc:  # poison step: fail waiters, live on
                self.session.fail_all(exc)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            # stepper still inside a (likely compiling) step: failing
            # the slots now would race its evictions (double page
            # frees).  Leave the daemon thread to drain; waiters keep
            # their deadlines.
            return
        self.session.fail_all(RuntimeError("generation engine stopped"))
