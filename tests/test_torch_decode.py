"""The port's generation-serving path (paddle_tpu_torch.decode and
``/generate``) against the JAX package, on the CPU.

Numpy-seeded inputs go to both packages; the decoder LM's weights cross
as numpy (``TinyDecoderLM.load_numpy`` of the JAX model's ``params``).
The JAX side runs as its own tests run it on the CPU: the ragged
paged-attention kernels in Pallas interpret mode and through their jnp
references, the model and session on the references.  The JAX model's
dense ``_forward`` is wrapped in ``jax.jit`` here (the same function,
compiled once per prompt length instead of op by op) to keep the file
fast.

Tolerances: the kernels' plain versions within 2e-5 of the Pallas
kernels and the references (as tests/test_decode.py:113: float32
softmax sums over up to 32 positions in another order); model logits
within 1e-5 (float32 through two small layers); token ids, beams and
HTTP replies exactly equal (beam scores within 1e-5).
"""

import copy
import json
import threading
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.decode import attention as jattn
from paddle_tpu.decode import paged_kv as jkv
from paddle_tpu.decode.engine import GenerationEngine as JaxEngine
from paddle_tpu.decode.model import TinyDecoderLM as JaxLM
from paddle_tpu.decode.prefix import PrefixCache as JaxPrefixCache
from paddle_tpu.decode.session import (BeamRequest as JaxBeamRequest,
                                       DecodeRequest as JaxRequest,
                                       DecodeSession as JaxSession)
from paddle_tpu.decode.spec import (NgramDraft as JaxNgram,
                                    SpeculativeDecoder as JaxSpec)
from paddle_tpu_torch.decode import attention as attn
from paddle_tpu_torch.decode import paged_kv as kv
from paddle_tpu_torch.decode.engine import GenerationEngine
from paddle_tpu_torch.decode.model import TinyDecoderLM
from paddle_tpu_torch.decode.prefix import PrefixCache
from paddle_tpu_torch.decode.session import (AdmissionRefused, BeamRequest,
                                             DecodeRequest, DecodeSession)
from paddle_tpu_torch.decode.spec import (ModelDraft, NgramDraft,
                                          SpeculativeDecoder)
from paddle_tpu_torch.kernels import paged_attention as kpa

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_ATOL = 1e-5
PROMPT = [1, 5, 9, 3, 7, 2, 8, 4, 6, 2, 3]
PROMPT_B = [1, 4, 4, 2, 9, 9, 6, 3, 8, 7, 5]      # same length: one compile
SHORT, SHORT_B = [2, 3, 4, 5, 6], [9, 8, 7, 1, 2]


def _np(a):
    return np.asarray(a)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels and references
# ---------------------------------------------------------------------------


def _paged_case(seed, s, h, d, page, n, p, lens, t=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(*((s, h, d) if t is None else (s, t, h, d))).astype(
        np.float32)
    kp = rng.randn(n, page, h, d).astype(np.float32)
    vp = rng.randn(n, page, h, d).astype(np.float32)
    tables = rng.randint(1, n, (s, p)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("slots_per_block", [1, 5])
def test_paged_attention_plain_matches_pallas_and_reference(slots_per_block):
    # ragged lengths incl. one-page, partial-page and full-capacity
    q, kp, vp, tables, lens = _paged_case(0, 5, 2, 16, 8, 12, 3,
                                          [3, 8, 17, 1, 24])
    got = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens))
    pallas = jattn.ragged_paged_attention(
        q, kp, vp, tables, lens, interpret=True,
        slots_per_block=slots_per_block)
    ref = jattn.ragged_paged_attention_reference(q, kp, vp, tables, lens)
    np.testing.assert_allclose(got.numpy(), _np(pallas), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), _np(ref), **KERNEL_TOL)
    np.testing.assert_array_equal(
        attn.paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                             _t(lens)).numpy(), got.numpy())


def test_paged_chunk_plain_matches_pallas_and_reference():
    # row limits lens + j + 1, the last slot's capped at P * page = 24
    q, kp, vp, tables, lens = _paged_case(1, 4, 2, 16, 8, 12, 3,
                                          [3, 8, 13, 22], t=4)
    got = kpa.paged_attention_chunk(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(lens))
    pallas = jattn.ragged_paged_attention_chunk(q, kp, vp, tables, lens,
                                                interpret=True)
    ref = jattn.ragged_paged_attention_chunk_reference(q, kp, vp, tables,
                                                       lens)
    np.testing.assert_allclose(got.numpy(), _np(pallas), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), _np(ref), **KERNEL_TOL)
    np.testing.assert_array_equal(
        attn.paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                   _t(lens)).numpy(), got.numpy())


def test_empty_context_gives_the_pallas_kernels_zeros():
    """lens 0: the Pallas kernel writes zeros (l == 0 -> 1); the jnp
    reference gives the mean of V (a fully masked softmax is uniform).
    The port follows the kernel; no caller attends over nothing."""
    q, kp, vp, tables, lens = _paged_case(0, 5, 2, 16, 8, 12, 3,
                                          [0, 8, 0, 1, 24])
    got = kpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables),
                              _t(lens)).numpy()
    pallas = _np(jattn.ragged_paged_attention(q, kp, vp, tables, lens,
                                              interpret=True))
    np.testing.assert_allclose(got, pallas, **KERNEL_TOL)
    assert np.abs(got[[0, 2]]).max() == 0.0
    ref = _np(jattn.ragged_paged_attention_reference(q, kp, vp, tables,
                                                     lens))
    assert np.abs(ref[0]).max() > 1e-3           # the reference's quirk
    np.testing.assert_allclose(got[[1, 3, 4]], ref[[1, 3, 4]], **KERNEL_TOL)


def test_paged_wrappers_check_their_inputs():
    q, kp, vp, tables, lens = (_t(a) for a in _paged_case(
        0, 2, 2, 16, 8, 12, 3, [3, 8]))
    before = kpa.launches, kpa.chunk_launches
    with pytest.raises(ValueError):
        kpa.paged_attention(q[:, None], kp, vp, tables, lens)
    with pytest.raises(ValueError):
        kpa.paged_attention(q, kp, vp[:, :4], tables, lens)
    with pytest.raises(ValueError):
        kpa.paged_attention(q, kp, vp, tables[:1], lens)
    assert attn.fits(16, 16, 128, 128) and not attn.fits(16, 16, 512, 128)
    kpa.paged_attention(q, kp, vp, tables, lens)
    kpa.paged_attention_chunk(q[:, None], kp, vp, tables, lens)
    assert (kpa.launches, kpa.chunk_launches) == before   # the CPU path


# ---------------------------------------------------------------------------
# the model: logits against the JAX model from the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_base():
    m = JaxLM(seed=3, num_pages=64)
    m._forward = jax.jit(m._forward)
    return m


def fresh_jax(base, num_pages=64):
    """The JAX model with its weights and a fresh allocator and pools."""
    m = copy.copy(base)
    m.allocator = jkv.PageAllocator(num_pages)
    shape = (m.layers, num_pages, m.page_size, m.heads, m.dh)
    m.k_pool = jnp.zeros(shape, jnp.float32)
    m.v_pool = jnp.zeros(shape, jnp.float32)
    return m


def port_of(jm, num_pages=None):
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    return TinyDecoderLM(vocab=jm.vocab, d_model=jm.d, num_heads=jm.heads,
                         num_layers=jm.layers, max_len=jm.max_len,
                         num_pages=num_pages or jm.allocator.num_pages,
                         page_size=jm.page_size,
                         pages_per_seq=jm.pages_per_seq, place=pt.CPUPlace(),
                         params=params)


def _pools_close(pm, jm):
    np.testing.assert_allclose(pm.k_pool.numpy(), _np(jm.k_pool), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(pm.v_pool.numpy(), _np(jm.v_pool), rtol=0,
                               atol=LOGIT_ATOL)


def test_model_prefill_decode_verify_logits_match_jax(jax_base):
    jm = fresh_jax(jax_base)
    pm = port_of(jm)
    tree = pm.to_numpy()
    np.testing.assert_array_equal(tree["layers"][1]["w2"],
                                  _np(jm.params["layers"][1]["w2"]))
    pages = [[1, 2], [3, 4, 5]]
    for m in (jm, pm):                 # both allocators hand out pages 1-5
        assert m.allocator.alloc(5) == [1, 2, 3, 4, 5]
    first = []
    for prompt, pg in ((PROMPT, pages[0]), (SHORT, pages[1])):
        _, _, jl = jm.prefill(prompt, pg)
        _, _, pl = pm.prefill(prompt, pg)
        np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
        first.append(int(np.argmax(pl)))
    _pools_close(pm, jm)
    # decode steps: two live slots
    tables = np.stack([pm.pool_table(p) for p in pages])
    lens = np.array([len(PROMPT), len(SHORT)], np.int64)
    toks = np.array([[first[0]], [first[1]]], np.int64)
    for _ in range(3):
        jl, _ = jm.decode(toks, [], tables, lens)
        pl, _ = pm.decode(toks, [], tables, lens)
        np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
        toks = np.argmax(pl, axis=-1)[:, None]
        lens = lens + 1
    _pools_close(pm, jm)
    # a verify step of 4 tokens per slot
    chunk = np.array([[5, 6, 7, 8], [2, 2, 3, 3]], np.int64)
    jl, _ = jm.verify_chunk(chunk, [], tables, lens)
    pl, _ = pm.verify_chunk(chunk, [], tables, lens)
    assert pl.shape == (2, 4, jm.vocab)
    np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
    _pools_close(pm, jm)
    # a prefix-hit prefill: the first page of PROMPT is cached in page 1
    _, _, jl = jm.prefill(PROMPT, [1, 6], cached_len=8)
    _, _, pl = pm.prefill(PROMPT, [1, 6], cached_len=8)
    np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
    _pools_close(pm, jm)
    with pytest.raises(ValueError):
        pm.prefill(PROMPT, [1, 6], cached_len=4)


def test_model_clamps_where_jax_clamps(jax_base):
    """pages_per_seq * page_size == max_len (8 * 8 == 64): a decode step
    at lens 63 and 64, and a verify step reaching past the table, give
    the JAX model's logits and pools (position rows and table columns
    clamped; the verify's rows past the table land in the null page)."""
    jm = fresh_jax(jax_base)
    pm = port_of(jm)
    assert jm.pages_per_seq * jm.page_size == jm.max_len
    rng = np.random.RandomState(4)   # the same context rows in both pools
    pm.k_pool.copy_(torch.from_numpy(rng.randn(*pm.k_pool.shape).astype(
        np.float32)))
    pm.v_pool.copy_(torch.from_numpy(rng.randn(*pm.v_pool.shape).astype(
        np.float32)))
    jm.k_pool, jm.v_pool = (jnp.asarray(t.numpy())
                            for t in (pm.k_pool, pm.v_pool))
    tables = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    lens = np.array([63, 64], np.int64)
    toks = np.array([[7], [3]], np.int64)
    jl, _ = jm.decode(toks, [], tables, lens)
    pl, _ = pm.decode(toks, [], tables, lens)
    np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
    _pools_close(pm, jm)
    chunk = np.array([[5, 6, 7, 8], [2, 2, 3, 300]], np.int64)   # 300 > V
    lens = np.array([58, 62], np.int64)
    jl, _ = jm.verify_chunk(chunk, [], tables, lens)
    pl, _ = pm.verify_chunk(chunk, [], tables, lens)
    np.testing.assert_allclose(pl, _np(jl), rtol=0, atol=LOGIT_ATOL)
    _pools_close(pm, jm)


def test_null_page_garbage_never_reaches_an_active_slot(jax_base):
    """Inactive slots write their K/V rows into null page 0 (duplicate
    scatter rows); what page 0 holds must never change an active slot."""
    pm = port_of(jax_base)
    pages = pm.allocator.alloc(2)
    _, _, first = pm.prefill(PROMPT, pages)
    tables = np.zeros((4, pm.pages_per_seq), np.int32)
    tables[1] = pm.pool_table(pages)
    lens = np.array([1, len(PROMPT), 1, 1], np.int64)
    toks = np.array([[1], [int(np.argmax(first))], [1], [1]], np.int64)
    saved = pm.k_pool.clone(), pm.v_pool.clone()
    clean, _ = pm.decode(toks, [], tables, lens)
    pm.k_pool.copy_(saved[0])
    pm.v_pool.copy_(saved[1])
    g = torch.Generator().manual_seed(5)
    pm.k_pool[:, 0] = 1e4 * torch.randn(pm.k_pool[:, 0].shape, generator=g)
    pm.v_pool[:, 0] = -1e4 * torch.randn(pm.v_pool[:, 0].shape, generator=g)
    dirty, _ = pm.decode(toks, [], tables, lens)
    np.testing.assert_array_equal(dirty[1], clean[1])
    # and a whole session over a garbage null page keeps the oracle
    pm.allocator.free(pages)
    want = [pm.dense_greedy(p, 6) for p in (PROMPT, SHORT)]
    sess = DecodeSession(pm, max_slots=4)
    reqs = [sess.submit(DecodeRequest(p, max_new_tokens=6))
            for p in (PROMPT, SHORT)]
    sess.run(max_steps=100)
    assert [r.result(0) for r in reqs] == want


# ---------------------------------------------------------------------------
# sessions: ids exactly the JAX session's
# ---------------------------------------------------------------------------


def _run(sess, reqs, steps=400):
    for r in reqs:
        sess.submit(r)
    sess.run(max_steps=steps)
    return [r.result(0) for r in reqs]


def test_session_greedy_with_churn_matches_jax_and_dense(jax_base):
    jm, pm = fresh_jax(jax_base), port_of(jax_base)
    prompts = [PROMPT, SHORT, PROMPT_B, SHORT_B]
    want = _run(JaxSession(jm, max_slots=2),           # 2 slots: churn
                [JaxRequest(list(p), max_new_tokens=8) for p in prompts])
    got = _run(DecodeSession(pm, max_slots=2),
               [DecodeRequest(list(p), max_new_tokens=8) for p in prompts])
    assert got == want
    assert got == [pm.dense_greedy(p, 8) for p in prompts]
    assert pm.allocator.pages_in_use == 0


def test_prefix_cache_parity_hits_and_pool_recovery(jax_base):
    """tests/test_decode_sharing.py:154 on both packages."""
    jm, pm = fresh_jax(jax_base), port_of(jax_base)
    sessions = []
    for m, cache_cls, sess_cls in ((jm, JaxPrefixCache, JaxSession),
                                   (pm, PrefixCache, DecodeSession)):
        cache = cache_cls(m.allocator, m.page_size, capacity_pages=16)
        sessions.append((cache, sess_cls(m, max_slots=2, prefix_cache=cache)))
    p3 = list(PROMPT[:8]) + [4, 4, 1, 3, 9, 9, 2, 5, 6]
    outs = []
    for (cache, sess), req_cls in zip(sessions, (JaxRequest, DecodeRequest)):
        out = []
        for prompt, budget in ((PROMPT, 8), (PROMPT, 8), (p3, 6)):
            out += _run(sess, [req_cls(list(prompt), max_new_tokens=budget)])
        outs.append((out, cache.stats()))
    assert outs[0] == outs[1]
    (o1, o2, o3), stats = outs[1]
    assert o1 == o2 == pm.dense_greedy(PROMPT, 8)
    assert o3 == pm.dense_greedy(p3, 6)
    assert stats["hits"] == 2 and stats["misses"] == 1
    assert pm.allocator.pages_in_use == sessions[1][0].cached_pages


@pytest.mark.parametrize("alloc_cls,cache_cls", [
    (jkv.PageAllocator, JaxPrefixCache), (kv.PageAllocator, PrefixCache)],
    ids=["jax", "port"])
def test_prefix_cache_bookkeeping(alloc_cls, cache_cls):
    """tests/test_decode_sharing.py:188-268 on both packages: capacity
    eviction, an insertion never evicting its own path, stats only for
    committed admissions, memory-pressure eviction of sole owners only."""
    ps = 8
    rng = np.random.RandomState(5)
    alloc = alloc_cls(64)
    cache = cache_cls(alloc, ps, capacity_pages=2)
    for _ in range(4):                      # 4 distinct 2-page prefixes
        prompt = [int(t) for t in rng.randint(2, 40, 17)]
        pages = alloc.alloc(2)
        cache.insert(prompt, pages)
        alloc.free(pages)                   # the cache holds its own refs
    assert cache.cached_pages <= 2 and cache.stats()["evictions"] >= 2
    cache.clear()
    assert alloc.pages_in_use == 0
    chain = cache_cls(alloc, ps, capacity_pages=1)
    prompt = list(range(2, 18))             # 2 full pages
    pages = alloc.alloc(2)
    chain.insert(prompt, pages)
    alloc.free(pages)
    assert chain.cached_pages == 1          # refused, not leaked
    chain.clear()
    assert alloc.pages_in_use == 0
    stats = cache_cls(alloc, ps, capacity_pages=4)
    prompt = list(range(2, 19))             # 2 full pages + 1
    pages = alloc.alloc(3)
    stats.insert(prompt, pages)
    alloc.free(pages)
    forked, saved = stats.match(prompt)
    assert saved == 16 and len(forked) == 2
    assert (stats.hits, stats.misses, stats.tokens_saved) == (0, 0, 0)
    alloc.free(forked)
    stats.commit_match(saved)
    stats.commit_match(0)
    assert (stats.hits, stats.misses, stats.tokens_saved) == (1, 1, 16)
    stats.clear()
    sole = cache_cls(alloc, ps, capacity_pages=6)
    pages = alloc.alloc(2)
    sole.insert(list(range(2, 18)), pages)
    assert sole.evict_for_pages(2) == 0     # a live sequence shares them
    alloc.free(pages)
    assert sole.evict_for_pages(2) == 2
    assert alloc.pages_in_use == 0


def test_spec_decode_matches_jax_and_greedy(jax_base):
    """tests/test_decode_sharing.py:271-301 on both packages."""
    from paddle_tpu_torch.observability import metrics

    jm, pm = fresh_jax(jax_base), port_of(jax_base)
    oracle = pm.dense_greedy(PROMPT, 12)
    assert JaxSpec(jm, JaxNgram(), k=4).generate(PROMPT, 12) == oracle
    assert SpeculativeDecoder(pm, NgramDraft(), k=4).generate(
        PROMPT, 12) == oracle
    assert SpeculativeDecoder(pm, ModelDraft(port_of(jax_base)),
                              k=4).generate(PROMPT, 12) == oracle
    assert pm.allocator.pages_in_use == 0
    proposed = metrics.counter("decode_spec_proposed_total").value()
    prompts = [PROMPT, SHORT, PROMPT_B]
    want = _run(JaxSession(jm, max_slots=2, spec_draft=JaxNgram(), spec_k=4),
                [JaxRequest(list(p), max_new_tokens=10) for p in prompts])
    got = _run(DecodeSession(pm, max_slots=2, spec_draft=NgramDraft(),
                             spec_k=4),
               [DecodeRequest(list(p), max_new_tokens=10) for p in prompts])
    assert got == want == [pm.dense_greedy(p, 10) for p in prompts]
    assert pm.allocator.pages_in_use == 0
    assert metrics.counter("decode_spec_proposed_total").value() > proposed
    assert "decode_spec_accepted_total" in metrics.snapshot()
    sess = DecodeSession(pm, max_slots=2, spec_draft=NgramDraft())
    with pytest.raises(AdmissionRefused) as e:
        sess.submit(DecodeRequest([1, 2], max_new_tokens=4, temperature=0.7,
                                  seed=1))
    assert e.value.reason == "spec_mode"


def test_beam_and_seeded_sampling_match_jax(jax_base):
    jm, pm = fresh_jax(jax_base), port_of(jax_base)
    results = []
    for m, sess_cls, beam_cls, req_cls in (
            (jm, JaxSession, JaxBeamRequest, JaxRequest),
            (pm, DecodeSession, BeamRequest, DecodeRequest)):
        sess = sess_cls(m, max_slots=2)
        beam = beam_cls(list(PROMPT), beam_size=2, max_new_tokens=8)
        sampled = [req_cls(list(PROMPT), max_new_tokens=8, temperature=0.9,
                           top_k=5, seed=s) for s in (42, 42, 7)]
        _run(sess, [beam] + sampled)
        results.append((beam.beams, [r.tokens for r in sampled]))
        assert m.allocator.pages_in_use == 0
    (jbeams, jsampled), (beams, sampled) = results
    assert [ids for _, ids in beams] == [ids for _, ids in jbeams]
    np.testing.assert_allclose([s for s, _ in beams], [s for s, _ in jbeams],
                               rtol=0, atol=1e-5)
    assert sampled == jsampled and sampled[0] == sampled[1]
    greedy = pm.dense_greedy(PROMPT, 8)
    sess = DecodeSession(pm, max_slots=2)
    one = BeamRequest(list(PROMPT), beam_size=1, max_new_tokens=8)
    _run(sess, [one])
    assert one.tokens == greedy


# ---------------------------------------------------------------------------
# host bookkeeping: allocator, copy-on-write, the page pool
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except (jkv.PoolExhausted, kv.PoolExhausted) as e:
        return ("exhausted", type(e).__name__)
    except ValueError as e:
        return ("value_error", str(e))


def test_allocator_refcounts_cow_and_exhaustion_match_jax():
    """The same random alloc/fork/free/cow sequence on both allocators
    gives the same results, refusals and refcounts."""
    rng = np.random.RandomState(9)
    ja, pa = jkv.PageAllocator(12), kv.PageAllocator(12)
    jowned, powned = [], []
    copies = {"jax": [], "port": []}
    for step in range(300):
        op = rng.randint(5)
        n = int(rng.randint(1, 4))
        pick = int(rng.randint(1 << 30))
        outs = []
        for a, owned, tag, mod in ((ja, jowned, "jax", jkv),
                                   (pa, powned, "port", kv)):
            if op == 0:
                out = _outcome(lambda: a.alloc(n))
                if out[0] == "ok":
                    owned.append(list(out[1]))
            elif op == 1 and owned:
                out = _outcome(lambda: a.fork(owned[pick % len(owned)]))
                if out[0] == "ok":
                    owned.append(list(out[1]))
            elif op == 2 and owned:
                out = _outcome(lambda: a.free(owned.pop(pick % len(owned))))
            elif op == 3 and owned:
                run = owned[pick % len(owned)]
                out = _outcome(lambda: mod.cow_split(
                    a, run, pick % len(run),
                    [lambda s, d, t=tag: copies[t].append((s, d))]))
            else:
                out = _outcome(lambda: a.free([pick % 13]))
            outs.append(out)
        assert outs[0] == outs[1], step
        assert ja._refs == pa._refs and ja._free == pa._free
        assert (ja.pages_in_use, ja.pages_shared, ja.total_refs) == (
            pa.pages_in_use, pa.pages_shared, pa.total_refs)
    assert copies["jax"] == copies["port"]


def test_paged_pool_writes_match_jax():
    jp = jkv.PagedPool(num_pages=6, page_size=4, feature_shape=(3,))
    pp = kv.PagedPool(num_pages=6, page_size=4, feature_shape=(3,))
    pages = pp.allocator.alloc(2)
    assert jp.allocator.alloc(2) == pages
    rows = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    for pool in (jp, pp):
        pool.write_rows(pages, rows)
        pool.append_row(pages, 6, np.full((3,), 7.0, np.float32))
        pool.copy_page(pages[0], 3)
    np.testing.assert_array_equal(pp.data.numpy(), _np(jp.data))
    np.testing.assert_array_equal(pp.page_table(pages, 4),
                                  jp.page_table(pages, 4))
    with pytest.raises(ValueError):
        pp.write_rows(pages, np.zeros((9, 3), np.float32))
    seq = kv.alloc_sequence(pp, 5, reserve_growth=3)
    fork = kv.fork_sequence(pp, seq)
    assert fork.pages == seq.pages and pp.allocator.is_shared(seq.pages[0])
    kv.free_sequence(pp, fork)
    kv.free_sequence(pp, seq)
    assert pp.allocator.pages_in_use == 2


# ---------------------------------------------------------------------------
# /generate against the JAX server
# ---------------------------------------------------------------------------


def _post(addr, payload, timeout=120):
    req = urllib.request.Request(
        f"http://{addr}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _reply(code, body):
    """Status and the parts of a reply both servers must agree on."""
    if code == 200:
        lines = [json.loads(x) for x in body.splitlines() if x.strip()]
        if len(lines) > 1:                              # streamed ndjson
            assert [x["token"] for x in lines[:-1]] == lines[-1]["ids"]
            return code, ("stream", [x.get("token") for x in lines[:-1]],
                          lines[-1])
        return code, lines[0]
    return code, json.loads(body).get("reason")


def _same(got, want):
    """Replies equal, beam scores within 1e-5."""
    if got[0] != want[0] or not isinstance(got[1], dict) or (
            "beams" not in got[1]):
        return got == want
    gb, wb = got[1]["beams"], want[1]["beams"]
    return ([b["ids"] for b in gb] == [b["ids"] for b in wb]
            and all(abs(g["score"] - w["score"]) <= 1e-5
                    for g, w in zip(gb, wb))
            and {k: v for k, v in got[1].items() if k != "beams"}
            == {k: v for k, v in want[1].items() if k != "beams"})


@pytest.fixture(scope="module")
def servers(jax_base):
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu_torch.serving import InferenceServer

    out = []
    for server_cls, engine_cls, model in (
            (JaxServer, JaxEngine, fresh_jax(jax_base)),
            (InferenceServer, GenerationEngine, port_of(jax_base))):
        engine = engine_cls(model, max_slots=2, max_new_tokens=8,
                            beam_max=2, prefix_cache=True)
        out.append(server_cls(None, generator=engine))
    yield out
    for srv in out:
        srv.stop()


REQUESTS = [
    {"src": PROMPT},                                     # streamed
    {"src": SHORT, "stream": False},
    {"src": PROMPT, "max_new_tokens": 3, "stream": False},   # cache hit
    {"src": PROMPT, "beam": 2},
    {"src": SHORT, "temperature": 0.9, "top_k": 5, "seed": 42,
     "stream": False},
    {"src": SHORT_B, "temperature": 0.8, "seed": 3},    # streamed, sampled
    {"src": "nope"},
    {"src": [1], "nucleus": 2},
    {"src": [1], "beam": 0},
    {"src": [1, 2], "top_k": 5, "stream": False},        # top_k without t
    {"src": [1], "beam": 4},                             # 503 beam_too_wide
    {"src": list(range(2, 60)), "stream": False},        # 503 too_long
]


def test_generate_replies_match_the_jax_server(servers):
    jsrv, psrv = servers
    for payload in REQUESTS:
        want = _reply(*_post(jsrv.address, payload))
        got = _reply(*_post(psrv.address, payload))
        assert _same(got, want), (payload, got, want)
    concurrent = [{"src": p, "stream": i % 2 == 0}
                  for i, p in enumerate([PROMPT, SHORT, PROMPT_B, SHORT_B])]
    got = [None] * len(concurrent)

    def one(i):
        got[i] = _reply(*_post(psrv.address, concurrent[i]))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(concurrent))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for g, p in zip(got, concurrent):
        assert _same(g, _reply(*_post(jsrv.address, p))), p
    health = [json.loads(urllib.request.urlopen(
        f"http://{s.address}/health", timeout=30).read())
        for s in (jsrv, psrv)]
    assert health[1]["generation"] == health[0]["generation"]
    assert health[1]["place"] == "CPUPlace()"
    model = psrv._generator.model
    cache = psrv._generator.session.prefix_cache
    assert model.allocator.pages_in_use == cache.cached_pages


def test_generate_deadline_is_504_like_jax(jax_base):
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu_torch.serving import InferenceServer

    codes = []
    for server_cls, engine_cls, model in (
            (JaxServer, JaxEngine, fresh_jax(jax_base)),
            (InferenceServer, GenerationEngine, port_of(jax_base))):
        srv = server_cls(None, generator=engine_cls(model, max_slots=2,
                                                    max_new_tokens=4),
                         request_timeout=1e-6)
        try:
            codes.append([_post(srv.address, p)[0]
                          for p in ({"src": SHORT, "stream": False},
                                    {"src": SHORT})])
        finally:
            srv.stop()
    assert codes == [[504, 504], [504, 504]]


def test_predict_on_a_generation_only_server_is_400(servers):
    _, psrv = servers
    req = urllib.request.Request(f"http://{psrv.address}/predict",
                                 data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


class _Slow:
    """A TinyDecoderLM whose decode step takes 20 ms and never picks EOS,
    so a stream outlives its consumer."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def decode(self, tokens, states, tables, lens):
        time.sleep(0.02)
        logits, st = self._inner.decode(tokens, states, tables, lens)
        logits[:, self._inner.eos_id] = -1e9
        return logits, st


def test_streaming_client_that_leaves_cancels_its_slot(jax_base):
    """A consumer that hangs up mid-stream frees its slot and pages."""
    import socket

    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import InferenceServer

    pm = port_of(jax_base)
    engine = GenerationEngine(_Slow(pm), max_slots=1, max_new_tokens=60)
    srv = InferenceServer(None, generator=engine)
    cancelled = metrics.counter("decode_cancelled_total").value()
    try:
        host, port = srv.address.split(":")
        body = json.dumps({"src": [1, 2, 3], "max_new_tokens": 60}).encode()
        with socket.create_connection((host, int(port)), timeout=30) as sock:
            sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode()
                         + body)
            assert b"200" in sock.recv(64)
        deadline = time.monotonic() + 30
        while not (engine.session.idle()
                   and metrics.counter("decode_cancelled_total").value()
                   > cancelled):
            assert time.monotonic() < deadline, "the slot was not cancelled"
            time.sleep(0.02)
        assert pm.allocator.pages_in_use == 0
        req = engine.submit([4, 5], max_new_tokens=3)
        assert len(req.result(timeout=60)) == 3
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the launcher and what is left for later slices
# ---------------------------------------------------------------------------


def test_launcher_builds_the_engine_from_a_gen_config(tmp_path):
    from paddle_tpu_torch.serving.__main__ import load_generator, main

    script = tmp_path / "gen.py"
    script.write_text(
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.decode.model import TinyDecoderLM\n"
        "def make_decode_model():\n"
        "    return TinyDecoderLM(num_pages=16, place=pt.CPUPlace())\n")

    class Args:
        gen_config = str(script)
        gen_slots, gen_queue, gen_max_tokens = 3, 5, 7
        prefix_cache, prefix_cache_pages = True, 4
        spec_draft, spec_k, beam_max = "ngram", 3, 0
        gen_pages, gen_page_size, gen_pages_per_seq = 16, 8, 2
        cpu = True

    engine = load_generator(Args)
    try:
        info = engine.info()
        assert (info["slots"], info["max_new_tokens"], info["speculative"],
                info["prefix_cache"]["capacity"]) == (3, 7, True, 4)
        assert engine.session.spec_k == 3
        assert len(engine.submit([1, 2, 3]).result(timeout=60)) == 7
    finally:
        engine.stop()
    # a make_generator() script: a v1 beam_search spec on the CPU
    script.write_text(
        "from paddle_tpu_torch.demos.seq2seq.gen_config import "
        "make_beam_gen\n"
        "from paddle_tpu_torch.executor import Scope\n"
        "class Params:\n"
        "    scope = Scope()\n"
        "def make_generator():\n"
        "    return make_beam_gen(beam_size=1, max_length=5), Params()\n")
    engine = load_generator(Args)
    try:
        assert type(engine.model).__name__ == "PagedSeq2SeqModel"
        assert (engine.info()["slots"], engine.info()["max_new_tokens"],
                engine.model.pool.num_pages) == (3, 7, 16)
        assert 1 <= len(engine.submit([4, 7, 2]).result(timeout=60)) <= 7
        assert engine.model.allocator.pages_in_use == 0
    finally:
        engine.stop()
    script.write_text("x = 1\n")
    with pytest.raises(RuntimeError, match="make_generator"):
        load_generator(Args)
    with pytest.raises(SystemExit):
        main([])


def test_later_slices_and_the_card_default_raise(jax_base):
    """for_seq2seq builds a PagedSeq2SeqModel engine on the place asked
    for (its replies are held to the JAX engine's in
    tests/test_torch_generation.py); without a place the decode models
    take the card, and raise where there is none."""
    import paddle_tpu_torch.decode as decode
    from paddle_tpu_torch.demos.seq2seq.gen_config import make_beam_gen
    from paddle_tpu_torch.executor import Scope

    class Params:
        scope = Scope()

    engine = GenerationEngine.for_seq2seq(
        make_beam_gen(beam_size=1, max_length=4), Params, num_pages=8,
        max_slots=2, place=pt.CPUPlace())
    try:
        assert isinstance(engine.model, decode.PagedSeq2SeqModel)
        assert engine.info()["max_new_tokens"] == 4
        assert engine.model.device.type == "cpu"
    finally:
        engine.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TinyDecoderLM()
        with pytest.raises(RuntimeError, match="CUDA"):
            GenerationEngine.for_seq2seq(make_beam_gen(), Params)
