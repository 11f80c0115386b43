"""Host-side index of the engine's shared-prefix KV cache, and KV block
sizing.

Own copy of `ray_tpu/models/prefix_cache.py` (the port imports nothing
of the JAX package); `_Node` and `PrefixCacheIndex` stay line for line
alike the JAX ones.

A radix/trie index at BLOCK granularity (``block_tokens`` tokens per
node; only full blocks are shareable) mapping token-sequence prefixes to
blocks of a device pool of cached K/V. The device half lives in
`models/engine.py`: the dense engine's copy-in/copy-out pool
(`_prefix_copy_in` / `_prefix_copy_out`), or, paged, the engine's own
block pool, whose blocks the trie shares by reference count. This index
never touches a device tensor, so matching and eviction cost nothing on
the device.

Ordering contract with the engine (single-threaded, stream-ordered): a
node is created PENDING when the engine plans to fill its block and
COMMITTED once the copy-out (dense) or the covering prefill (paged) has
been enqueued. `match` only walks committed nodes; eviction only takes
committed leaves. Work on one CUDA stream runs in the order it was
enqueued, so a block evicted and reassigned on the host is still read
with its OLD content by any work enqueued before the new owner's write.

Eviction is LRU over committed leaf nodes; interior nodes become leaves
as their children go, so cold chains drain tail-first while hot shared
prefixes survive.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.models.block_pool import BlockPool


def block_bytes(n_layers: int, block_tokens: int, kv_heads: int,
                head_dim: int, dtype_bytes: int, *,
                per_layer: bool = False) -> int:
    """Device bytes one pool block occupies (K and V).

    A block id indexes the ``NB`` axis of BOTH pool tensors
    ``[L, NB, T, KV, D]``, so one block holds T tokens' K/V for ALL
    ``n_layers`` layers: the default is the layer-summed figure
    ``2 * L * T * KV * D * dtype`` (the number a byte budget divides
    by); ``per_layer=True`` returns one layer's slice.

    Pool sizing from a byte budget is exact: a budget of
    ``k * block_bytes(...)`` buys exactly k usable blocks (the reserved
    null block 0 rides on top)."""
    layers = 1 if per_layer else n_layers
    return 2 * layers * block_tokens * kv_heads * head_dim * dtype_bytes


class _Node:
    __slots__ = ("key", "block_id", "parent", "children", "committed",
                 "last_use")

    def __init__(self, key: Optional[Tuple[int, ...]], block_id: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.committed = False
        self.last_use = 0


class PrefixCacheIndex:
    """Radix index over cached prompt prefixes at block granularity.

    ``match(prompt)`` returns the pool block ids of the longest
    COMMITTED chain of full blocks prefixing ``prompt`` — capped so the
    matched length never covers the whole prompt (the engine must
    always prefill at least the final token to have last-token logits
    to sample from, the same rule vLLM applies).

    ``extend(prompt)`` walks the chain for every full block of
    ``prompt`` and creates missing nodes as PENDING, allocating pool
    blocks from the free list (evicting LRU committed leaves when it
    runs dry). The caller fills each pending node's block from the
    owning row's prefilled K/V and then calls ``commit(node)``.

    Block id 0 is RESERVED as scratch: the copies pad their block-id
    vectors to a power of two with it; garbage scattered there is never
    indexed.

    PAGED MODE (``pool=`` a shared BlockPool): the index no longer
    owns a private free list — blocks belong to the engine-wide
    refcounted pool that also backs every live request's block table.
    The trie holds ONE pool reference per cached block (`register`
    increfs a row's freshly filled blocks instead of copying them out;
    warm admissions incref matched blocks instead of copying them in),
    and eviction is HARDENED: only blocks whose sole remaining holder
    is the trie itself (``pool.ref(bid) == 1``) are eviction
    candidates, so a block shared with any live (or swapped-out) row
    can never be recycled under its reader — the
    refcount-never-evicted property.
    """

    def __init__(self, *, block_tokens: int, n_blocks: int,
                 on_evict: Optional[Callable[[int], None]] = None,
                 pool: Optional[BlockPool] = None):
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        if n_blocks < 2:
            raise ValueError(
                "n_blocks must be >= 2 (block 0 is the scratch block); "
                "raise prefix_cache_bytes or shrink prefix_block")
        self.block_tokens = block_tokens
        self.n_blocks = n_blocks
        self.pool = pool
        self._free: List[int] = ([] if pool is not None
                                 else list(range(n_blocks - 1, 0, -1)))
        self._root = _Node(None, -1, None)
        self._nodes: List[_Node] = []
        self._clock = 0
        self.evictions = 0
        self._on_evict = on_evict

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def blocks_in_use(self) -> int:
        return len(self._nodes)

    @property
    def blocks_total(self) -> int:
        return self.n_blocks - 1          # scratch block excluded

    # -- core ops ----------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunk(self, prompt, j: int) -> Tuple[int, ...]:
        T = self.block_tokens
        return tuple(prompt[j * T:(j + 1) * T])

    def match(self, prompt, *, peek: bool = False,
              allow_full: bool = False) -> Tuple[List[int], bool]:
        """Longest committed full-block chain prefixing ``prompt``.

        Returns (block_ids, next_is_pending): the matched chain walks at
        most ``(len(prompt) - 1) // block_tokens`` blocks (at least one
        suffix token is always left for the engine to prefill), and
        ``next_is_pending`` reports whether the walk stopped at a node
        another row is still filling — the prefix-affinity scheduler
        defers such requests one step so they admit warm.

        ``allow_full=True`` lifts the one-suffix-token cap to
        ``len(prompt) // block_tokens`` — the PAGED engine's entry: a
        block-aligned prompt matching its whole chain shares every
        block and COPY-ON-WRITES the last one (recomputing only the
        final token inside the private copy for its logits), instead
        of recomputing a full block of suffix. The copy-in engine must
        NOT use this: it has no CoW, so writing the recomputed final
        token would land in the shared pool block.

        ``peek=True`` leaves LRU recency untouched: a pure read for
        load probes (the fleet router scores EVERY replica's trie per
        request — touching last_use from probes that lose the routing
        decision would let routing traffic evict genuinely hot blocks)."""
        node = self._root
        ids: List[int] = []
        cap = len(prompt) if allow_full else len(prompt) - 1
        max_blocks = cap // self.block_tokens
        while len(ids) < max_blocks:
            child = node.children.get(self._chunk(prompt, len(ids)))
            if child is None:
                return ids, False
            if not child.committed:
                return ids, True
            if not peek:
                child.last_use = self._tick()
            ids.append(child.block_id)
            node = child
        return ids, False

    def extend(self, prompt) -> List[Tuple[int, "_Node"]]:
        """Ensure a (possibly pending) node chain exists for every full
        block of ``prompt``; returns ``[(block_index, node), ...]`` for
        the nodes CREATED by this call — always a consecutive tail of
        the chain — which the caller must fill and ``commit``. Stops
        early (shorter list) if the pool runs dry even after LRU
        eviction; the uncached tail simply isn't shared."""
        node = self._root
        created: List[Tuple[int, _Node]] = []
        protect = {id(self._root)}
        for j in range(len(prompt) // self.block_tokens):
            key = self._chunk(prompt, j)
            child = node.children.get(key)
            if child is None:
                bid = self._alloc(protect)
                if bid is None:
                    break
                child = _Node(key, bid, node)
                node.children[key] = child
                self._nodes.append(child)
                created.append((j, child))
            child.last_use = self._tick()
            protect.add(id(child))
            node = child
        return created

    def register(self, prompt, block_ids: List[int]
                 ) -> List[Tuple[int, "_Node"]]:
        """Paged-mode twin of `extend`: bind the chain for every full
        block of ``prompt`` to the caller's OWN pool blocks
        (``block_ids[j]`` backs chain position j) instead of
        allocating fresh ones — the row that is about to prefill those
        blocks donates a share, so publication is zero-copy: the trie
        increfs each newly registered block and there is nothing to
        copy out when the prefill lands. Positions already in the trie
        are left untouched (their existing block holds identical
        content; the caller keeps its own reference to its own block).
        Returns the nodes CREATED — pending until the caller's prefill
        frontier covers them and it calls ``commit``."""
        if self.pool is None:
            raise ValueError("register() requires a pool-backed index "
                             "(pass pool= at construction)")
        node = self._root
        created: List[Tuple[int, _Node]] = []
        for j in range(len(prompt) // self.block_tokens):
            if j >= len(block_ids):
                break
            key = self._chunk(prompt, j)
            child = node.children.get(key)
            if child is None:
                self.pool.incref([block_ids[j]])
                child = _Node(key, block_ids[j], node)
                node.children[key] = child
                self._nodes.append(child)
                created.append((j, child))
            child.last_use = self._tick()
            node = child
        return created

    def commit(self, node: "_Node") -> None:
        """Mark a pending node's block as filled (copy-out enqueued)."""
        node.committed = True
        node.last_use = self._tick()

    # -- allocation / eviction ---------------------------------------------

    def _evictable(self, n: "_Node", protect) -> bool:
        """Eviction candidacy, HARDENED for the refcounted pool: a
        victim must be a committed childless leaf outside the caller's
        protected chain AND — when pool-backed — a block whose only
        remaining holder is the trie itself. A refcount above 1 means
        a live row's block table (or a swapped-out request) still
        reads the block; recycling it would corrupt that reader, so
        such blocks are simply not candidates until their last sharer
        releases them."""
        if n.children or not n.committed or id(n) in protect:
            return False
        if self.pool is not None and self.pool.ref(n.block_id) != 1:
            return False
        return True

    def _evict_victim(self, protect) -> Optional[int]:
        """Evict the LRU evictable leaf; returns its block id (with
        the trie's reference DROPPED in pool mode — the block is free
        unless someone else still holds it) or None."""
        victim = None
        for n in self._nodes:
            if not self._evictable(n, protect):
                continue
            if victim is None or n.last_use < victim.last_use:
                victim = n
        if victim is None:
            return None
        victim.parent.children.pop(victim.key, None)
        self._nodes.remove(victim)
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(1)
        if self.pool is not None:
            self.pool.decref([victim.block_id])
        return victim.block_id

    def evict_one(self) -> bool:
        """Release one cold cached block back to the shared pool
        (paged engines call this when `BlockPool.alloc` runs dry —
        cold cache always gives way before any live request is
        preempted). Returns False when nothing is evictable."""
        return self._evict_victim({id(self._root)}) is not None

    def evictable_blocks(self) -> int:
        """How many cached blocks COULD be released by repeated
        `evict_one` calls (the engine's admission gate counts these as
        available capacity; the fleet router scores replicas on free +
        evictable).

        This is the CASCADE fixpoint, not just the current leaves:
        evicting a childless leaf makes its parent childless, so a
        whole cold chain is reclaimable even though only its tail is
        evictable right now. Counting only the instantaneous leaves
        under-reports capacity and livelocks the paged engine's
        admission gate — `_fits_now` says a swapped-out request can
        never fit while `_pool_alloc`'s evict loop would in fact free
        the chain. A node is reclaimable iff it is committed, the trie
        holds its only reference, and EVERY descendant is
        reclaimable too (a shared or pending descendant pins the whole
        path to the root above it)."""
        def reclaimable(n) -> bool:
            if not n.committed:
                return False
            if self.pool is not None and self.pool.ref(n.block_id) != 1:
                return False
            return all(reclaimable(c) for c in n.children.values())

        return sum(sum(1 for _ in self._subtree_if(n, reclaimable))
                   for n in self._root.children.values())

    def _subtree_if(self, node, pred):
        """Yield `node`'s whole subtree when `pred(node)` holds (the
        cascade reclaims subtrees from the root down: an unreclaimable
        ancestor keeps its reclaimable descendants pinned only until
        the ancestor itself is evicted, which cannot happen while it
        has children — so reclaimability is decided at the subtree
        root)."""
        if not pred(node):
            for c in node.children.values():
                yield from self._subtree_if(c, pred)
            return
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _alloc(self, protect) -> Optional[int]:
        if self.pool is not None:
            ids = self.pool.alloc(1)
            if ids is not None:
                return ids[0]
            return self._evict_victim_realloc(protect)
        if self._free:
            return self._free.pop()
        return self._evict_victim(protect)

    def _evict_victim_realloc(self, protect) -> Optional[int]:
        """Pool-mode retry: evict one cold block, then re-alloc from
        the pool (the evicted block is only actually free if the trie
        was its last holder — `_evictable` guarantees it was)."""
        if self._evict_victim(protect) is None:
            return None
        ids = self.pool.alloc(1)
        return None if ids is None else ids[0]
