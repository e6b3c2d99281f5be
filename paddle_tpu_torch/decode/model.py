"""TinyDecoderLM: a decoder-only transformer over paged KV
(``paddle_tpu/decode/model.py``).

Prefill runs the dense causal forward (``dense_prefill_attention``, the
flash-attention forward) and pages the prompt's K/V once; every decode
step appends one K/V row per sequence into its pages and attends over
its page table through the ragged paged-attention kernel; the
prefix-hit suffix prefill and the speculative verify attend through the
chunk kernel.  The products are plain ``torch.matmul``, as the JAX
model leaves them to XLA.

Weights are random from a seed (an explicit ``torch.Generator`` on the
model's device): the model exists to prove the kernels and the session
mechanics, not to be a trained LM.  ``load_numpy`` takes the JAX model's
``params`` as nested numpy arrays, after which both packages compute the
same function.  The parameters, the K/V pools (L, N, page, H, dh) and
every step live on ``place`` (``CUDAPlace(0)`` unless the caller passes
``CPUPlace()``); the pools are written in place.  ``decode``,
``verify_chunk`` and ``prefill`` return numpy logits, because the
session chooses tokens on the host.

Where the JAX model's gathers rely on out-of-range clamping, the port
clamps explicitly (torch raises, and on CUDA a bad index kills the
process): token ids (negative ids count from the end, as ``jnp``
indexing does), position rows past ``max_len``, and page-table columns
past ``pages_per_seq`` in the decode step and the suffix prefill.  The
verify step's table lookup is ``take_along_axis``, whose fill value
wraps to a row of the null page for an even page size and drops the
write for an odd one; the port does the same.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.decode.attention import (
    dense_prefill_attention,
    paged_attention,
    paged_chunk_attention,
)
from paddle_tpu_torch.decode.paged_kv import PageAllocator
from paddle_tpu_torch.executor import _f32_math
from paddle_tpu_torch.framework import resolve_place

_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2")


def _init_params(gen, vocab, d, layers, max_len, device):
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device) * 0.02

    def ones(n):
        return torch.ones(n, device=device)

    params = {"emb": normal(vocab, d), "pos": normal(max_len, d),
              "ln_f": ones(d), "layers": []}
    for _ in range(layers):
        params["layers"].append({
            "ln1": ones(d), "ln2": ones(d),
            "wq": normal(d, d), "wk": normal(d, d), "wv": normal(d, d),
            "wo": normal(d, d), "w1": normal(d, 4 * d),
            "w2": normal(4 * d, d)})
    return params


def _ln(x, scale):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * scale


def _take(table, idx):
    """``table[idx]`` with jnp indexing's rule for ids out of range:
    negative ids count from the end, the rest clamp to the table."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    return table[idx.clamp(0, n - 1)]


def _mlp(x, lp):
    h2 = _ln(x, lp["ln2"])
    return x + F.gelu(h2 @ lp["w1"], approximate="tanh") @ lp["w2"]


class TinyDecoderLM:
    grows_kv = True
    supports_prefix_cache = True      # prefill accepts cached_len
    emits_probs = False               # decode returns raw logits
    state_specs: List[Tuple[tuple, type]] = []   # position == KV length

    def __init__(self, vocab: int = 64, d_model: int = 32,
                 num_heads: int = 4, num_layers: int = 2,
                 max_len: int = 64, num_pages: int = 32,
                 page_size: int = 8, pages_per_seq: int = 8,
                 bos_id: int = 1, eos_id: int = 0, seed: int = 0,
                 place=None, params=None):
        self.vocab, self.d = int(vocab), int(d_model)
        self.heads = int(num_heads)
        self.dh = self.d // self.heads
        self.layers = int(num_layers)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.bos_id, self.eos_id = int(bos_id), int(eos_id)
        self.place = resolve_place(place)
        self.device = self.place.device()
        self.allocator = PageAllocator(num_pages)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            self.params = _init_params(gen, self.vocab, self.d, self.layers,
                                       self.max_len, self.device)
        else:
            self.load_numpy(params)
        shape = (self.layers, num_pages, self.page_size, self.heads, self.dh)
        self.k_pool = torch.zeros(shape, device=self.device)
        self.v_pool = torch.zeros(shape, device=self.device)

    # -- weights ------------------------------------------------------------

    def _shapes(self) -> dict:
        d = self.d
        return {"emb": (self.vocab, d), "pos": (self.max_len, d),
                "ln_f": (d,), "ln1": (d,), "ln2": (d,), "wq": (d, d),
                "wk": (d, d), "wv": (d, d), "wo": (d, d), "w1": (d, 4 * d),
                "w2": (4 * d, d)}

    def load_numpy(self, tree) -> None:
        """Take the JAX model's ``params`` (``emb``, ``pos``, ``ln_f`` and
        ``layers[i]`` with ``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``,
        ``wo``, ``w1``, ``w2``) as numpy arrays, onto this model's
        device as float32."""
        shapes = self._shapes()

        def one(name, value):
            arr = np.array(value, np.float32)
            if arr.shape != shapes[name]:
                raise ValueError(f"param {name!r} has shape {arr.shape}, "
                                 f"this model wants {shapes[name]}")
            return torch.as_tensor(arr).to(self.device)

        if len(tree["layers"]) != self.layers:
            raise ValueError(f"{len(tree['layers'])} layers given, this "
                             f"model has {self.layers}")
        self.params = {k: one(k, tree[k]) for k in ("emb", "pos", "ln_f")}
        self.params["layers"] = [{k: one(k, lp[k]) for k in _LAYER_KEYS}
                                 for lp in tree["layers"]]

    def to_numpy(self) -> dict:
        """The parameters as the nested numpy tree ``load_numpy`` takes."""
        tree = {k: self.params[k].cpu().numpy()
                for k in ("emb", "pos", "ln_f")}
        tree["layers"] = [{k: lp[k].cpu().numpy() for k in _LAYER_KEYS}
                          for lp in self.params["layers"]]
        return tree

    def _math(self):
        """float32 products at float32 (TF32 off) on the card."""
        if self.device.type == "cuda":
            return _f32_math()
        return contextlib.nullcontext()

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- dense forward (prefill + test oracle) ------------------------------

    def _forward(self, tokens: torch.Tensor):
        """Full dense causal forward over (T,) tokens -> (logits (T, V),
        per-layer K/V rows (L, T, heads, dh))."""
        p = self.params
        T = tokens.shape[0]
        x = _take(p["emb"], tokens) + p["pos"][:T]
        ks, vs = [], []
        for lp in p["layers"]:
            h = _ln(x, lp["ln1"])
            q = (h @ lp["wq"]).reshape(T, self.heads, self.dh)
            k = (h @ lp["wk"]).reshape(T, self.heads, self.dh)
            v = (h @ lp["wv"]).reshape(T, self.heads, self.dh)
            ks.append(k)
            vs.append(v)
            a = dense_prefill_attention(q, k, v, causal=True)
            x = _mlp(x + a.reshape(T, self.d) @ lp["wo"], lp)
        logits = _ln(x, p["ln_f"]) @ p["emb"].T
        return logits, torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def dense_greedy(self, prompt: Sequence[int],
                     max_new_tokens: int) -> List[int]:
        """The no-cache oracle: re-run the full forward per token."""
        ids = list(prompt)
        out = []
        with self._math():
            for _ in range(max_new_tokens):
                logits, _, _ = self._forward(self._tensor(ids, torch.long))
                tok = int(torch.argmax(logits[-1]))
                out.append(tok)
                if tok == self.eos_id:
                    break
                ids.append(tok)
        return out

    # -- session contract ---------------------------------------------------

    def context_pages(self, prompt, max_new_tokens: int) -> int:
        total = len(prompt) + int(max_new_tokens)
        return max(1, -(-total // self.page_size))

    def pool_table(self, pages: Sequence[int]) -> np.ndarray:
        t = np.zeros((self.pages_per_seq,), np.int32)
        t[:len(pages)] = np.asarray(pages, np.int32)
        return t

    @torch.no_grad()
    def prefill(self, prompt: Sequence[int], pages: Sequence[int],
                cached_len: int = 0):
        """Page the prompt's K/V and return (ctx_len, states, last
        logits as numpy).  With ``cached_len`` > 0 (a prefix-cache hit)
        the first ``cached_len`` rows already live in ``pages``: only the
        suffix is computed, attending over the cached pages through the
        chunk kernel, and only the suffix's K/V rows are written."""
        toks = self._tensor(list(prompt), torch.long)
        T = toks.shape[0]
        with self._math():
            if cached_len:
                if not (0 < cached_len < T
                        and cached_len % self.page_size == 0):
                    raise ValueError(
                        f"cached_len {cached_len} must be a positive "
                        f"multiple of page_size strictly inside the "
                        f"{T}-token prompt")
                logits = self._prefill_chunk(
                    self._tensor(self.pool_table(pages), torch.int32),
                    int(cached_len), toks[cached_len:])
                return int(T), [], logits[-1].cpu().numpy()
            logits, ks, vs = self._forward(toks)
            n = len(pages)
            pad = n * self.page_size - T
            idx = self._tensor(list(pages), torch.long)
            for pool, rows in ((self.k_pool, ks), (self.v_pool, vs)):
                pool[:, idx] = F.pad(rows, (0, 0, 0, 0, 0, pad)).reshape(
                    self.layers, n, self.page_size, self.heads, self.dh)
            return int(T), [], logits[-1].cpu().numpy()

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        """Device copy of one page across both pools (the CoW split)."""
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    @torch.no_grad()
    def verify_chunk(self, tokens: np.ndarray, states, tables: np.ndarray,
                     lens: np.ndarray):
        """Speculative verification: feed ``k`` tokens per slot in ONE
        step (tokens (S, k)), appending all k K/V rows and attending
        with per-row causal offsets.  Returns logits (S, k, V) as numpy
        — row j scores the token *after* tokens[:, j].  Rejected rows
        stay past ``lens``, unreachable through the length mask."""
        with self._math():
            logits = self._verify_step(self._tensor(tables, torch.int32),
                                       self._tensor(lens, torch.int32),
                                       self._tensor(tokens, torch.long))
            return logits.cpu().numpy(), []

    @torch.no_grad()
    def decode(self, tokens: np.ndarray, states, tables: np.ndarray,
               lens: np.ndarray):
        """One token for every slot (tokens (S, 1)): append K/V into
        pages, attend over the page tables.  Returns logits (S, V) as
        numpy."""
        with self._math():
            logits = self._decode_step(self._tensor(tables, torch.int32),
                                       self._tensor(lens, torch.int32),
                                       self._tensor(tokens[:, 0], torch.long))
            return logits.cpu().numpy(), []

    # -- the steps ----------------------------------------------------------

    def _write(self, li: int, flat: torch.Tensor, k, v) -> None:
        """Rows ``flat`` of layer ``li``'s pools (as (N * page, H, dh))
        take k and v, in place."""
        n_rows = self.k_pool.shape[1] * self.page_size
        for pool, rows in ((self.k_pool, k), (self.v_pool, v)):
            pool[li].view(n_rows, self.heads, self.dh).index_copy_(
                0, flat, rows)

    def _layers(self, x, write, attend):
        """The stack shared by the paged steps: each layer writes the new
        K/V rows (``write(li, k, v)``) and attends (``attend(li, q)``)."""
        lead = x.shape[:-1]
        for li, lp in enumerate(self.params["layers"]):
            h = _ln(x, lp["ln1"])
            q, k, v = ((h @ lp[w]).reshape(*lead, self.heads, self.dh)
                       for w in ("wq", "wk", "wv"))
            write(li, k, v)
            a = attend(li, q)
            x = _mlp(x + a.reshape(*lead, self.d) @ lp["wo"], lp)
        return _ln(x, self.params["ln_f"]) @ self.params["emb"].T

    def _prefill_chunk(self, table, cached_len: int, tokens):
        """Suffix prefill over cached pages: the suffix's Ts tokens are one
        chunk at positions cached_len..cached_len+Ts-1; attention sees the
        cached prefix rows plus the causal part of the suffix itself."""
        Ts = tokens.shape[0]
        p = self.params
        pos = cached_len + torch.arange(Ts, device=self.device)
        x = _take(p["emb"], tokens) + _take(p["pos"], pos)
        col = (pos // self.page_size).clamp(max=self.pages_per_seq - 1)
        flat = table.long()[col] * self.page_size + pos % self.page_size
        lens1 = torch.tensor([cached_len], dtype=torch.int32,
                             device=self.device)
        return self._layers(
            x, lambda li, k, v: self._write(li, flat, k, v),
            lambda li, q: paged_chunk_attention(
                q[None], self.k_pool[li], self.v_pool[li], table[None],
                lens1)[0])

    def _verify_step(self, tables, lens, tokens):
        """k tokens for every slot in one step: append all k K/V rows,
        attend with per-row causal offsets through the chunk kernel."""
        S, T = tokens.shape
        pg = self.page_size
        pos = lens.long()[:, None] + torch.arange(T, device=self.device)
        x = _take(self.params["emb"], tokens) + _take(self.params["pos"], pos)
        col = pos // pg
        past = col >= self.pages_per_seq
        page = torch.gather(tables.long(), 1,
                            col.clamp(max=self.pages_per_seq - 1))
        page = page.masked_fill(past, PageAllocator.NULL_PAGE)
        flat = (page * pg + pos % pg).reshape(-1)
        keep = (~past).reshape(-1) if pg % 2 else None

        def write(li, k, v):
            k, v = k.reshape(S * T, *k.shape[2:]), v.reshape(S * T, *v.shape[2:])
            if keep is None:
                self._write(li, flat, k, v)
            else:
                self._write(li, flat[keep], k[keep], v[keep])

        return self._layers(
            x, write, lambda li, q: paged_chunk_attention(
                q, self.k_pool[li], self.v_pool[li], tables, lens))

    def _decode_step(self, tables, lens, tokens):
        """One token for every slot: append K/V into pages, attend over
        the page tables with ``lens + 1``.  Inactive slots hold the null
        table, so they write into reserved page 0, harmlessly: no active
        slot reads page 0."""
        S = tokens.shape[0]
        pg = self.page_size
        x = _take(self.params["emb"], tokens) + _take(self.params["pos"],
                                                      lens.long())
        col = (lens.long() // pg).clamp(max=self.pages_per_seq - 1)
        flat = (tables.long()[torch.arange(S, device=self.device), col] * pg
                + lens.long() % pg)
        return self._layers(
            x, lambda li, k, v: self._write(li, flat, k, v),
            lambda li, q: paged_attention(
                q, self.k_pool[li], self.v_pool[li], tables, lens + 1))
