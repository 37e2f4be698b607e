"""Prefix cache: a trie of published KV page chains (DESIGN.md §8, §8a);
a copy of ``repro.serve.prefix_cache`` (plain Python).

The SplitFS mechanism, one level up: where the paged controller maps a
SEQUENCE to its extents, the prefix cache maps PROMPT CONTENT to extents —
a content-addressed directory over the same pool.  Each trie edge is one
FULL page's worth of token ids; each node holds the physical page that a
prior sequence published for exactly that token chunk.  Admission walks
the trie and attaches the new sequence to the longest matching chain via
``PagedKVCache.adopt_prefix`` — the same refcounted full-page sharing
(hard links) that ``fork`` uses.  A shared prefix therefore costs ZERO
prefill compute and ZERO fresh pages; only the divergent tail is staged
and computed.

With a host tier attached (``core.tier.HostTier``), residency is PER NODE:
a node is either DEVICE-resident (``page`` points into the pool, one
cache-owned pin) or HOST-resident (``host_slot`` names an arena slot, no
pin, no pool page).  Chain identity is token content, so a chain may mix
residencies freely; a host link is adoptable via the engine's staged
promotion path.  Eviction becomes a ladder — demote before forget — so
capacity pressure changes a chain's residency instead of destroying it.

Safety invariants (tested in tests/test_serve_api.py, tests/test_tier.py):
  * only FULL, PUBLISHED pages enter the trie — an adopter's first append
    opens a fresh page, so shared bytes are never rewritten (no CoW needed
    at attach; fork's CoW tail still covers post-adoption forks);
  * every DEVICE-cached page carries a cache-owned refcount PIN, so it
    survives the writing sequence's ``free_seq`` without leaking:
    eviction unpins, and the pool reclaims the page when the last
    sequence drops it; host-resident nodes hold no pin at all;
  * FORGETTING (removing a node from the trie) is leaf-first in LRU
    order — an interior node is never forgotten while a longer cached
    chain still runs through it (a matched chain must be adoptable
    atomically).  DEMOTION has no such restriction: it changes residency,
    not membership, so any idle device node may demote;
  * unpin and forget are SEPARATE steps (the demotion hook interposes
    between them): demote snapshots bytes D2H, THEN unpins — never the
    reverse, or the snapshot could read a freed page.

The cache is metadata-only and mode-agnostic: pages published by a STRICT
session may be adopted by a POSIX one and vice versa; adoption logs under
the ADOPTER's own mode (per-seq modes, core.kvcache).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.kvcache import PagedKVCache
from ..core.tier import HostTier


@dataclass
class _Node:
    page: int                            # physical DEVICE page (-1 on host)
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_used: int = 0                   # LRU clock tick
    host_slot: Optional[int] = None      # arena slot while HOST-resident

    @property
    def on_host(self) -> bool:
        return self.host_slot is not None


class PrefixCache:
    """Content-addressed index of published page chains over one pool.

    ``capacity_pages`` bounds how many pages the cache may pin at once
    (default: half the pool minus the null page); ``release`` frees pool
    pages under engine backpressure — demoting to the host ``tier`` when
    one is attached, forgetting leaf-first LRU pins otherwise.
    """

    def __init__(self, controller: PagedKVCache,
                 capacity_pages: Optional[int] = None,
                 tier: Optional[HostTier] = None) -> None:
        self.controller = controller
        self.page_tokens = controller.geom.page_tokens
        if capacity_pages is None:
            capacity_pages = max(1, (controller.geom.num_pages - 1) // 2)
        self.capacity_pages = capacity_pages
        self.tier = tier
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._pinned = 0
        self._clock = itertools.count(1)
        # stats (plain ints; the obs registry reads them lazily)
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.pages_evicted = 0
        self.demotions = 0                   # device -> host residency flips
        self.promotions = 0                  # host -> device (engine commits)
        self.upgrades = 0                    # host node re-published on device
        self.match_pages_sum = 0             # partial-match depth, summed
        self.deepest_match = 0               # deepest adoptable match seen

    # ---------------------------------------------------------------- match

    def match_links(self, prompt: Sequence[int], *, align: int = 1,
                    ) -> Tuple[List[_Node], int]:
        """Longest cached chain covering a prefix of ``prompt``, as trie
        NODES (residency included — host links need the engine's staged
        promotion path).  The match is trimmed so that (a) at least ONE
        prompt token is left to feed — the engine samples the first output
        from the final prefill chunk's logits, so a whole-prompt hit must
        still run one chunk — and (b) the covered length is a multiple of
        ``align`` (the engine's chunk size C: chunks must keep starting
        on the C-grid the staging reserve assumes)."""
        pt = self.page_tokens
        chain: List[_Node] = []
        level = self._root
        for i in range(len(prompt) // pt):
            key = tuple(prompt[i * pt:(i + 1) * pt])
            node = level.get(key)
            if node is None:
                break
            chain.append(node)
            level = node.children
        # trim: leave >= 1 token to feed, and stay on the chunk grid
        n = len(chain)
        while n and (n * pt >= len(prompt) or (n * pt) % align):
            n -= 1
        chain = chain[:n]
        # LRU-stamp only what the caller can actually ADOPT — stamping the
        # trimmed tail would keep never-adoptable chains perpetually fresh
        # and invert the eviction order for zero-value entries
        tick = next(self._clock)
        for node in chain:
            node.last_used = tick
        n_tokens = n * pt
        if n_tokens:
            self.hits += 1
            self.tokens_saved += n_tokens
            self.match_pages_sum += n
            self.deepest_match = max(self.deepest_match, n)
        else:
            self.misses += 1
        return chain, n_tokens

    def match(self, prompt: Sequence[int], *, align: int = 1,
              ) -> Tuple[List[int], int]:
        """Device-only view of ``match_links``: (physical pages, tokens).
        The chain is cut at the first host-resident link — every returned
        page is directly adoptable via ``adopt_prefix`` — then re-trimmed
        to the ``align`` grid."""
        chain, _ = self.match_links(prompt, align=align)
        keep = 0
        for node in chain:
            if node.on_host:
                break
            keep += 1
        pt = self.page_tokens
        while keep and (keep * pt) % align:
            keep -= 1
        return [node.page for node in chain[:keep]], keep * pt

    # ---------------------------------------------------------------- insert

    def insert(self, prompt: Sequence[int], extents: Dict[int, int]) -> int:
        """Register a sequence's published prompt pages.

        ``extents`` is the controller's committed extent map {logical page
        index -> physical page} for the sequence that just finished
        ingesting ``prompt``.  Only pages wholly inside the prompt are
        cached (the page straddling prompt/output holds generated tokens).
        Idempotent: an existing DEVICE node for the same token chunk keeps
        its page (first writer wins; the duplicate pin is never taken).
        An existing HOST node is UPGRADED in place — the inserter just
        re-published identical bytes on device, so the node flips back to
        device residency for free (no copy) and its arena slot returns.
        Returns the number of NEW pages pinned."""
        pt = self.page_tokens
        level = self._root
        added = 0
        tick = next(self._clock)
        for i in range(len(prompt) // pt):
            if i not in extents:
                break                      # not published (shouldn't happen)
            key = tuple(prompt[i * pt:(i + 1) * pt])
            node = level.get(key)
            if node is None:
                if self._pinned >= self.capacity_pages and \
                        not self._make_room(before_tick=tick):
                    break                  # at capacity, nothing evictable
                node = _Node(page=extents[i])
                self.controller.pin_page(node.page)
                self._pinned += 1
                level[key] = node
                added += 1
            elif node.on_host:
                if self._pinned >= self.capacity_pages and \
                        not self._make_room(before_tick=tick):
                    break                  # stay host-resident for now
                self.controller.pin_page(extents[i])
                self._pinned += 1
                if self.tier is not None:
                    self.tier.free(node.host_slot)
                node.host_slot = None
                node.page = extents[i]
                self.upgrades += 1
            node.last_used = tick
            level = node.children
        return added

    # ---------------------------------------------------------------- promote

    def promote_commit(self, link: _Node, new_page: int,
                       host_slot: int) -> bool:
        """The engine's flip callback: a staged promotion of ``link`` into
        device page ``new_page`` has been enqueued — re-pin the node on
        device and release the arena slot.  Returns False when another
        promotion already flipped this node (its arena slot moved on): the
        caller's copy of the page stays privately owned by its adopter,
        and nothing here changes."""
        if not link.on_host or link.host_slot != host_slot:
            return False
        # the pin may push _pinned past capacity transiently; the next
        # insert's _make_room rebalances (demoting LRU, possibly this one)
        self.controller.pin_page(new_page)
        self._pinned += 1
        link.page = new_page
        link.host_slot = None
        if self.tier is not None:
            self.tier.free(host_slot)
        self.promotions += 1
        return True

    # ---------------------------------------------------------------- evict

    def release(self, n_pages: int) -> int:
        """Free up to ``n_pages`` POOL pages — the engine's backpressure
        hook.  The ladder (DESIGN.md §8a): DEMOTE idle device pins to the
        host tier first (the chain stays matchable; the pool page
        returns); when the arena is full, drop the host tier's LRU leaf
        (it is a loss-tolerant cache) to make room and retry; only
        without a tier — or when it is jammed — fall back to the
        destructive leaf forget.  Only IDLE pins count either way (page
        refcount 1: the cache holds the sole reference, so releasing it
        really returns the page); touching a pin shared with a live
        sequence would free nothing and cost a future hit.  Returns pages
        freed."""
        freed = 0
        while freed < n_pages:
            if self.tier is not None:
                victim = self._lru_device(idle_only=True)
                if victim is None:
                    break
                if self._demote(victim):
                    freed += 1
                    continue
                if self._drop_host_leaf():
                    continue               # made arena room; retry demote
                # arena jammed by interior host nodes: destructive below
            idle = [t for t in self._leaves()
                    if not t[2].on_host
                    and self.controller.page_refcount(t[2].page) == 1]
            if not idle:
                break
            idle.sort(key=lambda t: t[2].last_used)
            for level, key, node in idle[:n_pages - freed]:
                self._evict(level, key, node)
                freed += 1
        return freed

    def clear(self) -> None:
        """Drop EVERY entry, device or host, shared or idle (teardown)."""
        while True:
            leaves = self._leaves()
            if not leaves:
                break
            for level, key, node in leaves:
                self._evict(level, key, node)

    def _iter_nodes(self) -> Iterator[_Node]:
        stack: List[Dict[Tuple[int, ...], _Node]] = [self._root]
        while stack:
            level = stack.pop()
            for node in level.values():
                yield node
                if node.children:
                    stack.append(node.children)

    def _lru_device(self, before_tick: Optional[int] = None, *,
                    idle_only: bool = False) -> Optional[_Node]:
        """LRU device-resident node (ANY node, not just leaves — demotion
        changes residency, not trie membership, so a host-resident
        interior link keeps its chain adoptable via staged promotion)."""
        best: Optional[_Node] = None
        for node in self._iter_nodes():
            if node.on_host:
                continue
            if before_tick is not None and node.last_used >= before_tick:
                continue
            if idle_only and \
                    self.controller.page_refcount(node.page) != 1:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        return best

    def _demote(self, node: _Node) -> bool:
        """Device -> host residency flip.  Order matters: the D2H
        snapshot runs FIRST, while the cache's pin still holds the page
        alive; only then is the pin dropped (this is why unpin and forget
        are split)."""
        slot = self.tier.demote(node.page)
        if slot is None:
            return False
        self._unpin(node)
        node.host_slot = slot
        node.page = -1
        self.demotions += 1
        return True

    def _drop_host_leaf(self, before_tick: Optional[int] = None) -> bool:
        """Make arena room: forget the LRU host-resident LEAF (the host
        tier is loss-tolerant — dropping costs future prefill recompute,
        never correctness)."""
        hosted = [t for t in self._leaves(before_tick) if t[2].on_host]
        if not hosted:
            return False
        self._evict(*min(hosted, key=lambda t: t[2].last_used))
        return True

    def _leaves(self, before_tick: Optional[int] = None,
                ) -> List[Tuple[Dict, Tuple[int, ...], "_Node"]]:
        """All forgettable leaves (nodes with no children — interior nodes
        stay until every chain through them is gone, so a matched chain is
        always adoptable whole).  ``before_tick`` exempts nodes stamped
        at/after it: an in-flight insert stamps its walked chain first, so
        eviction can never drop the parent (and with it the whole pinned
        subtree) of the node being added."""
        out: List[Tuple[Dict, Tuple[int, ...], _Node]] = []
        stack: List[Dict[Tuple[int, ...], _Node]] = [self._root]
        while stack:
            level = stack.pop()
            for key, node in level.items():
                if node.children:
                    stack.append(node.children)
                elif before_tick is None or node.last_used < before_tick:
                    out.append((level, key, node))
        return out

    def _unpin(self, node: "_Node") -> None:
        """Drop the cache's device pin — the page returns to the pool if
        no live sequence shares it.  Half of the old one-step eviction;
        ``_forget`` is the other half."""
        self.controller.unpin_page(node.page)
        self._pinned -= 1

    def _forget(self, level: Dict, key: Tuple[int, ...], node: "_Node",
                ) -> None:
        """Remove a node from the trie.  A device node must be unpinned
        FIRST (the split lets ``_demote`` interpose a D2H snapshot between
        the two steps); a host node's arena slot is returned here."""
        del level[key]
        if node.on_host:
            if self.tier is not None:
                self.tier.free(node.host_slot, promoted=False)
            node.host_slot = None

    def _evict(self, level: Dict, key: Tuple[int, ...], node: "_Node",
               ) -> None:
        """Destructive removal (unpin + forget in one step) — the no-tier
        fallback and the host-leaf drop path."""
        if not node.on_host:
            self._unpin(node)
        self._forget(level, key, node)
        self.pages_evicted += 1

    def _make_room(self, before_tick: Optional[int] = None) -> bool:
        """Free ONE device pin for an incoming insert.  Same ladder as
        ``release`` but for the PIN budget rather than pool pages, so the
        victim need not be idle: demoting a shared pin still returns its
        pin (the page stays alive through the sharing sequence)."""
        if self.tier is not None:
            victim = self._lru_device(before_tick, idle_only=True) \
                or self._lru_device(before_tick)
            if victim is not None:
                if self._demote(victim):
                    return True
                if self._drop_host_leaf(before_tick) and \
                        self._demote(victim):
                    return True
        # no tier (or it is jammed): forget one leaf — IDLE victims first
        # (a shared pin is a hot chain and evicting it frees no pool
        # page), LRU within each class
        leaves = [t for t in self._leaves(before_tick)
                  if not t[2].on_host]
        if not leaves:
            return False
        idle = [t for t in leaves
                if self.controller.page_refcount(t[2].page) == 1]
        self._evict(*min(idle or leaves, key=lambda t: t[2].last_used))
        return True

    # ---------------------------------------------------------------- stats

    @property
    def pinned_pages(self) -> int:
        return self._pinned

    @property
    def host_nodes(self) -> int:
        return sum(1 for n in self._iter_nodes() if n.on_host)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "tokens_saved": self.tokens_saved,
                "pinned_pages": self._pinned,
                "pages_evicted": self.pages_evicted,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "upgrades": self.upgrades,
                "host_pages": self.tier.host_pages if self.tier else 0,
                "match_pages_sum": self.match_pages_sum,
                "deepest_match": self.deepest_match}
