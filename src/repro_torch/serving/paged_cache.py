"""Paged KV cache: block-pool allocator, hash-chained prefix tree, and the
per-slot controller that ``ServingEngine`` drives.

A copy of ``repro/serving/paged_cache.py`` (host numpy; the port keeps its
own copy rather than importing the JAX package).

The cache is split HOST/DEVICE:

* Device side (inside the decode step) there are only flat KV POOLS —
  ``(num_blocks + 1) * page`` token rows shared by every slot — plus the
  matching φ-compressed pools.  The step reads/writes them through a
  ``(B, n_pages)`` int32 BLOCK TABLE and a ``(B,)`` per-slot length vector
  (``core.nsa_causal.nsa_causal_decode_paged``).  The final block is the
  TRASH block: inactive slots' writes and unallocated-page reads are routed
  there, so the step never needs data-dependent shapes.
* Host side (this module) lives all allocation POLICY: a free-list
  :class:`BlockAllocator` with per-block refcounts, per-slot block tables and
  lengths as numpy arrays (pushed to the step as arguments each call — they
  are tiny), and a :class:`PrefixCache` tree keyed by hash-chained token
  pages so identical prompt prefixes REUSE cached blocks across requests.

Invariants (the JAX package's property tests pin them on its copy):

* every block is either on the free list or refcounted > 0 — never both,
  never neither (no leaks, no double-free);
* a block's refcount equals the number of live references: slot table
  entries pointing at it plus prefix-tree nodes holding it;
* a prefix-tree lookup returns a block only for an exact token-prefix match
  (hash-chained SHA-256 over (parent chain, page tokens));
* shared blocks are never written: a slot that must write into a block with
  refcount > 1 first COPIES it (copy-on-write) — the controller emits the
  copy as a host op the engine applies to the device pools.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = ["BlockAllocator", "PrefixCache", "PagedKVCache", "CopyOp"]


class BlockAllocator:
    """Fixed-pool free-list allocator with per-block refcounts.

    Blocks are ints in ``[0, num_blocks)``.  ``alloc`` returns a block with
    refcount 1 (or None when exhausted); ``incref``/``decref`` manage
    sharing, and a block returns to the free list exactly when its count
    hits zero.
    """

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = np.zeros(num_blocks, np.int64)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def alloc(self) -> int | None:
        if not self._free:
            return None
        b = self._free.pop()
        assert self._ref[b] == 0, f"block {b} on free list with refcount {self._ref[b]}"
        self._ref[b] = 1
        return b

    def incref(self, block: int) -> int:
        if self._ref[block] <= 0:
            raise RuntimeError(f"incref on free block {block}")
        self._ref[block] += 1
        return int(self._ref[block])

    def decref(self, block: int) -> int:
        if self._ref[block] <= 0:
            raise RuntimeError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
        return int(self._ref[block])

    def check(self) -> None:
        """Assert the no-leak invariant (free + referenced == all blocks)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate blocks on free list"
        for b in range(self.num_blocks):
            held = self._ref[b] > 0
            assert held != (b in free), (
                f"block {b}: refcount {self._ref[b]}, on_free={b in free}")


class _PrefixNode:
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key: bytes, block: int, parent: "_PrefixNode | None"):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[bytes, _PrefixNode] = {}
        self.last_used = 0


class PrefixCache:
    """Hash-chained prefix tree: one node per FULL prompt page.

    Page ``i`` of a prompt is keyed by ``h_i = sha256(h_{i-1} || tokens of
    page i)`` — the chain makes the key depend on the whole prefix, so two
    different prefixes can never collide on a node (modulo SHA-256).  Each
    node holds one block id and one allocator reference; lookups touch nodes
    (LRU clock) and :meth:`evict_lru` releases cold LEAF nodes when the pool
    runs dry.
    """

    def __init__(self, allocator: BlockAllocator, page: int):
        self.allocator = allocator
        self.page = page
        self._root = _PrefixNode(b"", -1, None)
        self._nodes: dict[bytes, _PrefixNode] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._nodes)

    @staticmethod
    def _chain(prev: bytes, chunk: np.ndarray) -> bytes:
        h = hashlib.sha256()
        h.update(prev)
        h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
        return h.digest()

    def chain_keys(self, tokens: np.ndarray) -> list[bytes]:
        """Chain hash key per full page of ``tokens``."""
        keys, prev = [], b""
        for i in range(len(tokens) // self.page):
            prev = self._chain(prev, tokens[i * self.page:(i + 1) * self.page])
            keys.append(prev)
        return keys

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Blocks caching the longest full-page prefix of ``tokens``.

        Does NOT take references — the caller increfs the blocks it actually
        uses.  Touches the returned nodes' LRU clocks.
        """
        self._clock += 1
        node, blocks = self._root, []
        for key in self.chain_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._clock
            blocks.append(child.block)
            node = child
        return blocks

    def insert(self, tokens: np.ndarray, page_idx: int, block: int) -> bool:
        """Register ``block`` as the cache of page ``page_idx`` of ``tokens``.

        All earlier pages must already be in the tree (prompts are sealed
        in order).  Takes ONE allocator reference on behalf of the tree.
        Returns False (and takes no reference) if the node already exists —
        first writer wins.
        """
        keys = self.chain_keys(tokens)
        if page_idx >= len(keys):
            raise ValueError(f"page {page_idx} not a full page of {len(tokens)} tokens")
        node = self._root
        for key in keys[:page_idx]:
            node = node.children[key]        # KeyError ⇒ out-of-order seal (bug)
        key = keys[page_idx]
        if key in node.children:
            return False
        self._clock += 1
        child = _PrefixNode(key, block, node)
        child.last_used = self._clock
        node.children[key] = child
        self._nodes[key] = child
        self.allocator.incref(block)
        return True

    def evict_lru(self, n_blocks: int = 1) -> int:
        """Drop up to ``n_blocks`` least-recently-used LEAF nodes, releasing
        their tree references.  Returns how many were dropped (a block only
        actually frees when no slot still references it)."""
        dropped = 0
        while dropped < n_blocks:
            leaves = [nd for nd in self._nodes.values() if not nd.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            victim.parent.children.pop(victim.key)
            del self._nodes[victim.key]
            self.allocator.decref(victim.block)
            dropped += 1
        return dropped

    def clear(self) -> None:
        while self._nodes:
            self.evict_lru(len(self._nodes))


@dataclasses.dataclass(frozen=True)
class CopyOp:
    """Device-pool copy the engine must apply: block ``src`` → ``dst``
    (token rows ``[src*page, (src+1)*page)`` and the matching compressed
    rows).  Emitted by copy-on-write and never reordered across a step."""

    src: int
    dst: int


class PagedKVCache:
    """Host-side controller for one engine: allocator + tables + prefix tree.

    ``n_slots`` fixed decode slots share ``num_blocks`` pool blocks of
    ``page`` tokens each; a slot may hold at most ``n_pages`` pages
    (``capacity == n_pages * page`` tokens).  The TRASH block id is
    ``num_blocks`` — the device pools carry one extra block for it, and
    unallocated table entries point there.
    """

    def __init__(self, *, n_slots: int, num_blocks: int, page: int,
                 n_pages: int, prefix_cache: bool = True):
        if page <= 0 or n_pages <= 0:
            raise ValueError("page and n_pages must be positive")
        self.n_slots = n_slots
        self.page = page
        self.n_pages = n_pages
        self.trash = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = PrefixCache(self.allocator, page) if prefix_cache else None
        self.table = np.full((n_slots, n_pages), self.trash, np.int32)
        self.lengths = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self.version = 0                 # bumped on every TABLE mutation, so
        self.blocks_reused = 0           # the engine re-pushes the device
        self.cow_copies = 0              # copy only when it actually changed

    @property
    def capacity(self) -> int:
        return self.n_pages * self.page

    # -- allocation with prefix-tree backpressure ---------------------------

    def _alloc(self) -> int:
        b = self.allocator.alloc()
        while b is None and self.prefix is not None and len(self.prefix):
            if not self.prefix.evict_lru(1):
                break
            b = self.allocator.alloc()
        if b is None:
            raise RuntimeError(
                f"KV pool exhausted: {self.allocator.num_blocks} blocks of "
                f"{self.page} tokens all referenced — raise num_blocks or "
                "lower concurrency")
        return b

    def _slot_pages(self, slot: int) -> int:
        """Pages currently referenced by ``slot`` (covering its length; the
        page being written counts as soon as any token landed in it)."""
        return -(-int(self.lengths[slot]) // self.page)

    # -- slot lifecycle -----------------------------------------------------

    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Claim ``slot`` for a new request.  Looks the prompt up in the
        prefix tree and reuses every cached full page strictly below the
        last prompt position (the final position must be recomputed: its
        step produces the logits that sample the first generated token).
        Returns the number of prompt tokens already served from cache."""
        assert not self.active[slot], f"slot {slot} still active"
        assert self.table[slot, 0] == self.trash, f"slot {slot} not retired"
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.capacity:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds slot "
                             f"capacity {self.capacity}")
        reused = 0
        if self.prefix is not None:
            blocks = self.prefix.lookup(prompt)
            reused = min(len(blocks) * self.page, len(prompt) - 1)
            n_ref = -(-reused // self.page)          # pages covering [0, reused)
            for p in range(n_ref):
                self.allocator.incref(blocks[p])
                self.table[slot, p] = blocks[p]
            self.blocks_reused += n_ref
        self.lengths[slot] = reused
        self.active[slot] = True
        self.version += 1
        return reused

    def retire(self, slot: int) -> None:
        """Release the slot: drop its table references (blocks still held by
        the prefix tree or other slots survive) and mark it free."""
        for p in range(self._slot_pages(slot)):
            self.allocator.decref(int(self.table[slot, p]))
        self.table[slot] = self.trash
        self.lengths[slot] = 0
        self.active[slot] = False
        self.version += 1

    def fork(self, dst: int, src: int) -> None:
        """Clone ``src``'s sequence into free slot ``dst`` by sharing every
        block (incref, no copy).  The first write either side makes into a
        shared page copy-on-writes it apart."""
        assert not self.active[dst] and self.active[src]
        for p in range(self._slot_pages(src)):
            b = int(self.table[src, p])
            self.allocator.incref(b)
            self.table[dst, p] = b
        self.lengths[dst] = self.lengths[src]
        self.active[dst] = True
        self.version += 1

    # -- per-step page management -------------------------------------------

    def prepare_window(self, slot: int, n: int) -> list[CopyOp]:
        """Make positions ``[lengths[slot], lengths[slot]+n)`` writable
        before an n-step decode window.

        Copy-on-writes the tail page when it is shared (refcount > 1 — e.g.
        a fully-cached prompt whose last position must be recomputed, or a
        forked slot) and allocates a fresh block for every later page the
        window touches.  Returns the device copies the engine must apply to
        every layer's pools.
        """
        assert self.active[slot]
        t = int(self.lengths[slot])
        if t + n > self.capacity:
            raise RuntimeError(f"slot {slot} overflow: window [{t}, {t + n}) "
                               f"exceeds capacity {self.capacity}")
        p_last = (t + n - 1) // self.page
        ops: list[CopyOp] = []
        if t % self.page:                        # partially-written tail page
            pg = t // self.page
            src = int(self.table[slot, pg])
            if self.allocator.refcount(src) > 1:
                dst = self._alloc()
                ops.append(CopyOp(src=src, dst=dst))
                self.allocator.decref(src)
                self.table[slot, pg] = dst
                self.cow_copies += 1
                self.version += 1
            p_first = pg + 1
        else:
            p_first = t // self.page
        for pg in range(p_first, p_last + 1):
            assert self.table[slot, pg] == self.trash, \
                f"slot {slot} page {pg} already mapped at its first token"
            self.table[slot, pg] = self._alloc()
            self.version += 1
        return ops

    def prepare_append(self, slot: int) -> list[CopyOp]:
        """Make position ``lengths[slot]`` writable (one-step window)."""
        return self.prepare_window(slot, 1)

    def committed(self, slot: int, n: int = 1) -> None:
        """Account ``n`` tokens written from ``lengths[slot]`` (post-step)."""
        self.lengths[slot] += n

    def seal_prompt_pages(self, slot: int, prompt: np.ndarray,
                          prev_len: int) -> int:
        """Publish every page that filled ENTIRELY with prompt tokens while
        the slot advanced from ``prev_len`` to ``lengths[slot]``, so later
        requests reuse it.  Returns how many pages were newly inserted
        (existing nodes win; no-op when prefix caching is off)."""
        if self.prefix is None:
            return 0
        last = min(int(self.lengths[slot]), len(prompt))
        first = prev_len - prev_len % self.page + self.page   # > prev_len
        sealed = 0
        for m in range(first, last + 1, self.page):
            pg = m // self.page - 1
            sealed += bool(self.prefix.insert(prompt[:m], pg,
                                              int(self.table[slot, pg])))
        return sealed

    def seal_prompt_page(self, slot: int, prompt: np.ndarray) -> bool:
        """One-step variant: seal the page ending exactly at ``lengths``."""
        return self.seal_prompt_pages(slot, prompt,
                                      int(self.lengths[slot]) - 1) > 0

    def check(self) -> None:
        """Assert refcounts == live references (slots + tree)."""
        refs = np.zeros(self.allocator.num_blocks, np.int64)
        for s in range(self.n_slots):
            for p in range(self._slot_pages(s)):
                refs[int(self.table[s, p])] += 1
        if self.prefix is not None:
            for nd in self.prefix._nodes.values():
                refs[nd.block] += 1
        for b in range(self.allocator.num_blocks):
            assert refs[b] == self.allocator.refcount(b), (
                f"block {b}: {refs[b]} live references vs refcount "
                f"{self.allocator.refcount(b)}")
        self.allocator.check()
