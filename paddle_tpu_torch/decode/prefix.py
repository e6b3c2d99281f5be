"""Prefix cache: prompt-token trie -> retained KV page runs.

Fleet traffic repeats prompt prefixes (system prompts, few-shot
preambles) verbatim; with copy-on-write refcounts (paged_kv) the pages
holding a prefix's K/V are safely shareable, so recomputing them per
request is pure waste.  This cache maps *full-page* chunks of prompt
tokens to the physical page that holds their K/V:

- granularity is one page (``page_size`` tokens): causal K/V depends
  only on the tokens at and before a position, so a page whose tokens
  match byte-for-byte holds exactly the K/V a new prompt needs;
- the trie edge key is the page's token chunk, so matching is a walk:
  each matched node contributes one page, forked (refcount bumped) into
  the requesting sequence's page list;
- a match never covers the whole prompt: admission must still compute
  at least the final prompt token so first-token logits exist, so at
  most ``(len(prompt) - 1) // page_size`` pages match;
- the cache itself holds one reference per retained page.  LRU eviction
  drops leaf nodes; a dropped node releases its reference, and when no
  live sequence shares the page it returns to the free list — eviction
  under memory pressure only counts nodes whose page the cache is the
  *sole* owner of (``refcount == 1``), because only those give memory
  back.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.observability import metrics as _metrics

_M_HIT = _metrics.counter(
    "decode_prefix_cache_hit_total",
    "admissions that reused at least one cached prefix page")
_M_MISS = _metrics.counter(
    "decode_prefix_cache_miss_total",
    "admissions that found no cached prefix page")
_M_SAVED = _metrics.counter(
    "decode_prefix_cache_tokens_saved_total",
    "prompt tokens whose prefill was skipped via cached pages")
_M_CACHED = _metrics.gauge(
    "decode_prefix_cache_pages", "pages currently retained by the prefix "
    "cache (each holds one allocator reference)")
_M_EVICT = _metrics.counter(
    "decode_prefix_cache_evictions_total",
    "trie nodes evicted (LRU), by cause")


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "stamp")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = int(page)
        self.parent = parent
        self.children: dict = {}
        self.stamp = 0


class PrefixCache:
    """Trie of full-page prompt chunks over a refcounted allocator."""

    def __init__(self, allocator, page_size: int,
                 capacity_pages: Optional[int] = None):
        self.allocator = allocator
        self.page_size = int(page_size)
        # default bound: the cache may retain at most half the pool, so
        # steady-state admission always has pages to work with
        if capacity_pages is None:
            capacity_pages = max(1, (allocator.num_pages - 1) // 2)
        self.capacity_pages = int(capacity_pages)
        self._root: dict = {}          # chunk -> _Node (depth-0 children)
        self._size = 0                 # retained pages (== trie nodes)
        self._clock = 0                # LRU stamp source
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.evictions = 0

    # -- introspection ------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return self._size

    def stats(self) -> dict:
        return {"pages": self._size, "capacity": self.capacity_pages,
                "hits": self.hits, "misses": self.misses,
                "tokens_saved": self.tokens_saved,
                "evictions": self.evictions}

    # -- match / insert -----------------------------------------------------

    def _chunks(self, prompt: Sequence[int], limit_tokens: int):
        ps = self.page_size
        for i in range(limit_tokens // ps):
            yield tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``: returns (pages,
        cached_len) where ``pages`` are *forked* (one new reference each,
        owned by the caller) and ``cached_len = len(pages) * page_size``.
        Caps at ``len(prompt) - 1`` tokens so the admitting prefill
        always computes the final prompt token's logits.

        Stats are NOT counted here: admission may still fail (pool full
        -> pages freed, request requeued, re-matched next tick), so the
        caller reports the outcome via ``commit_match`` once the
        prefill actually ran."""
        self._clock += 1
        node_map = self._root
        run: List[_Node] = []
        for chunk in self._chunks(prompt, max(0, len(prompt) - 1)):
            node = node_map.get(chunk)
            if node is None:
                break
            node.stamp = self._clock
            run.append(node)
            node_map = node.children
        # re-stamp ancestors too: a hit deep in the trie keeps the whole
        # path hot, so LRU cannot evict a parent before its children
        if run:
            pages = self.allocator.fork([n.page for n in run])
            return pages, len(pages) * self.page_size
        return [], 0

    def commit_match(self, cached_len: int) -> None:
        """Record the outcome of a ``match`` whose admission committed
        (the prefill ran with ``cached_len`` tokens skipped)."""
        if cached_len > 0:
            self.hits += 1
            _M_HIT.inc()
            self.tokens_saved += cached_len
            _M_SAVED.inc(cached_len)
        else:
            self.misses += 1
            _M_MISS.inc()

    def insert(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Retain the prompt's full pages: ``pages[i]`` must hold the
        K/V of tokens ``[i*ps, (i+1)*ps)``.  Existing nodes are kept
        (first writer wins); new nodes fork their page.  Returns the
        number of pages newly retained."""
        self._clock += 1
        node_map = self._root
        parent: Optional[_Node] = None
        path_ids: set = set()          # nodes the walk already crossed
        added = 0
        for i, chunk in enumerate(self._chunks(prompt, len(prompt))):
            node = node_map.get(chunk)
            if node is None:
                # eviction must never pick a node on this insertion
                # path: dropping the just-walked parent would attach
                # the new child to a detached subtree, leaking its page
                if (self._size >= self.capacity_pages
                        and not self._evict_lru(1, require_sole=False,
                                                exclude=path_ids)):
                    break
                self.allocator.fork([pages[i]])
                node = _Node(chunk, pages[i], parent)
                node_map[chunk] = node
                self._size += 1
                added += 1
            node.stamp = self._clock
            parent = node
            path_ids.add(id(node))
            node_map = node.children
        _M_CACHED.set(self._size)
        return added

    # -- eviction -----------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _drop(self, node: _Node) -> None:
        owner = node.parent.children if node.parent else self._root
        del owner[node.chunk]
        self.allocator.free([node.page])
        self._size -= 1

    def _evict_lru(self, count: int, require_sole: bool,
                   exclude: Optional[set] = None) -> int:
        """Drop up to ``count`` LRU leaf nodes.  With ``require_sole``,
        only nodes whose page has no other owner qualify (eviction must
        actually return memory); without it, any leaf qualifies (the
        capacity bound trims the trie even when slots still share).
        ``exclude`` (node ids) protects an in-flight insertion path."""
        cause = "memory" if require_sole else "capacity"
        dropped = 0
        while dropped < count:
            leaves = self._leaves()
            if require_sole:
                leaves = [n for n in leaves
                          if self.allocator.refcount(n.page) == 1]
            if exclude:
                leaves = [n for n in leaves if id(n) not in exclude]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.stamp)
            self._drop(victim)
            _M_EVICT.inc(cause=cause)
            self.evictions += 1
            dropped += 1
        _M_CACHED.set(self._size)
        return dropped

    def evict_for_pages(self, need: int) -> int:
        """Memory-pressure eviction: free sole-owner LRU nodes until
        ``need`` pages went back to the free list (or no candidate
        remains).  Returns pages actually freed."""
        return self._evict_lru(max(0, int(need)), require_sole=True)

    def clear(self) -> None:
        while self._size:
            if not self._evict_lru(self._size, require_sole=False):
                break
