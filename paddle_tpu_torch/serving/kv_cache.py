"""KV caches for continuous batching: slot-based and paged.

Counterpart of ``paddle_tpu/serving/kv_cache.py``.

:class:`SlotKVCache` keeps one fixed ``[n_layers, n_slots, max_len,
kv_heads, head_dim]`` slab pair: every slot reserves ``max_len`` lines.

:class:`PagedKVCache` keeps a fixed ``[n_layers, n_blocks, block_size, kv,
hd]`` pool pair plus host-side per-slot block tables (numpy int32): slots
draw fixed-size blocks on demand, and requests sharing a prompt prefix
share its full blocks through a refcounted radix index
(:class:`RadixIndex`), copy-on-write on the partial tail block.

Block 0 is a reserved TRASH block: never allocated; writes that must not
land anywhere real (bucket padding, shared-prefix positions, inactive
decode rows) are redirected into it, and the causal bound keeps it
unreadable.

The bookkeeping (allocators, radix, block tables, position mirrors) is the
JAX package's, host-side numpy, copied as is. The slabs and pools
``kc``/``vc`` are torch tensors on the model's device and are updated IN
PLACE by the engine's prefill, chunk and decode (the JAX programs donated
and returned them).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

TRASH_BLOCK = 0   # reserved scatter target for masked writes, never allocated


class SlotKVCache:
    """Fixed-shape per-layer KV slabs on ``device`` plus a host-side slot
    allocator."""

    def __init__(self, n_layers, n_slots, max_len, kv_heads, head_dim,
                 dtype, device="cpu"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2")
        self.n_layers = int(n_layers)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        shape = (self.n_layers, self.n_slots, self.max_len, self.kv_heads,
                 self.head_dim)
        self.kc = torch.zeros(shape, dtype=dtype, device=device)
        self.vc = torch.zeros(shape, dtype=dtype, device=device)
        # host mirrors of per-slot state
        self.cur_pos = np.zeros(self.n_slots, np.int32)
        self.active = np.zeros(self.n_slots, bool)
        self._free = collections.deque(range(self.n_slots))

    @property
    def n_free(self):
        return len(self._free)

    @property
    def n_active(self):
        return int(self.active.sum())

    @property
    def occupancy(self):
        return self.n_active / self.n_slots

    def alloc(self):
        """Claim the lowest free slot (FIFO over frees) or return None."""
        if not self._free:
            return None
        slot = self._free.popleft()
        self.active[slot] = True
        self.cur_pos[slot] = 0
        return slot

    def free(self, slot):
        """Evict: the slot becomes reusable; device lines are NOT cleared
        -- a later occupant overwrites each line before it becomes
        attendable (causal bound), so stale KV is never read."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self._free.append(slot)

    def nbytes(self):
        return 2 * self.kc.numel() * self.kc.element_size()


class BlockPool:
    """Refcounted fixed-size block allocator (host-side, ids only).

    Block 0 is the reserved trash block and is never handed out; a
    block's refcount counts every holder — each slot referencing it plus
    the radix index if it holds the block for reuse. ``deref`` returns
    the block to the free list when the count reaches zero.
    """

    def __init__(self, n_blocks):
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is trash)")
        self.n_blocks = int(n_blocks)
        self.refcount = np.zeros(self.n_blocks, np.int32)
        self.refcount[TRASH_BLOCK] = 1       # pinned forever
        self._free = collections.deque(range(1, self.n_blocks))

    @property
    def n_free(self):
        return len(self._free)

    @property
    def n_used(self):
        return self.n_blocks - 1 - len(self._free)

    def alloc(self):
        """Claim a free block at refcount 1, or None when exhausted."""
        if not self._free:
            return None
        b = self._free.popleft()
        self.refcount[b] = 1
        return b

    def ref(self, b):
        if self.refcount[b] < 1:
            raise ValueError(f"block {b} is not allocated")
        self.refcount[b] += 1

    def deref(self, b):
        if b == TRASH_BLOCK:
            return
        if self.refcount[b] < 1:
            raise ValueError(f"block {b} double-freed")
        self.refcount[b] -= 1
        if self.refcount[b] == 0:
            self._free.append(b)


class _RadixNode:
    __slots__ = ("children", "block", "parent", "key")

    def __init__(self, parent=None, key=None, block=None):
        self.children = {}          # chunk bytes -> _RadixNode
        self.parent = parent
        self.key = key
        self.block = block


class RadixIndex:
    """Prefix trie over full-block token chunks -> pool block ids.

    Each node below the root owns exactly one full block of prompt
    tokens (keyed by the chunk's byte content — exact tokens, no hash
    collisions) and holds one pool reference on that block, so a prefix
    stays resident for reuse after its producing request finishes.
    ``match`` returns the longest already-cached full-chunk prefix;
    ``evict`` reclaims leaf blocks nobody but the index references when
    the pool runs dry (newest-inserted leaves last: old shared system
    prompts survive churn).
    """

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self.root = _RadixNode()
        self.n_nodes = 0
        self._clock = 0
        self._touch = {}            # node -> last-use tick (LRU eviction)

    def _chunks(self, tokens):
        bs = self.block_size
        t = np.asarray(tokens, np.int32)
        for i in range(len(t) // bs):
            yield t[i * bs:(i + 1) * bs].tobytes()

    def match(self, tokens):
        """Longest cached full-block prefix of ``tokens`` -> block ids
        (in prefix order). Does NOT take pool references — callers ref
        the returned blocks while the radix lock on them still holds."""
        node = self.root
        out = []
        self._clock += 1
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child.block)
            self._touch[child] = self._clock
            node = child
        return out

    def insert(self, tokens, block_ids, pool):
        """Register ``tokens``' full blocks (already written to
        ``block_ids``, one per full chunk) for future sharing. Chunks
        already present keep their existing block (the caller's private
        copy of that chunk stays owned by its slot alone); each newly
        inserted node takes one pool reference on its block."""
        node = self.root
        self._clock += 1
        inserted = 0
        for key, b in zip(self._chunks(tokens), block_ids):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(parent=node, key=key, block=int(b))
                node.children[key] = child
                pool.ref(child.block)
                self.n_nodes += 1
                inserted += 1
            self._touch[child] = self._clock
            node = child
        return inserted

    def _leaves(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                yield n
            stack.extend(n.children.values())

    def evictable_blocks(self, pool):
        """Number of index-held blocks reclaimable right now (leaf
        chain): blocks only the index references."""
        return sum(1 for n in self._nodes()
                   if pool.refcount[n.block] == 1)

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, pool, need=1):
        """Drop least-recently-matched leaves whose block nobody else
        references until ``need`` blocks are freed (or no progress).
        Returns the number of blocks actually freed."""
        freed = 0
        while freed < need:
            cand = [n for n in self._leaves()
                    if pool.refcount[n.block] == 1]
            if not cand:
                break
            victim = min(cand, key=lambda n: self._touch.get(n, 0))
            pool.deref(victim.block)
            del victim.parent.children[victim.key]
            self._touch.pop(victim, None)
            self.n_nodes -= 1
            freed += 1
        return freed


class PagedKVCache:
    """Paged KV pool + host-side slot/block bookkeeping: the slot surface
    (``alloc``/``free``/``active``/``cur_pos``/``n_free``/``occupancy``),
    the ``[n_slots, max_blocks]`` int32 block tables, the refcounted pool
    and the radix prefix index."""

    def __init__(self, n_layers, n_slots, max_len, kv_heads, head_dim,
                 dtype, block_size=16, n_blocks=None, device="cpu"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if max_len < 2:
            raise ValueError("max_len must be >= 2")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_layers = int(n_layers)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.block_size = int(block_size)
        self.max_blocks = -(-self.max_len // self.block_size)
        if n_blocks is None:
            # worst-case capacity of n_slots * max_len lines (+ trash):
            # paging can never run dry under slot-equivalent load;
            # size it DOWN explicitly to bank the memory win
            n_blocks = self.n_slots * self.max_blocks + 1
        self.pool = BlockPool(n_blocks)
        self.radix = RadixIndex(self.block_size)
        shape = (self.n_layers, self.pool.n_blocks, self.block_size,
                 self.kv_heads, self.head_dim)
        self.kc = torch.zeros(shape, dtype=dtype, device=device)
        self.vc = torch.zeros(shape, dtype=dtype, device=device)
        self.block_tables = np.zeros((self.n_slots, self.max_blocks),
                                     np.int32)      # 0 = trash/unused
        self.cur_pos = np.zeros(self.n_slots, np.int32)
        self.active = np.zeros(self.n_slots, bool)
        self._free = collections.deque(range(self.n_slots))
        self._slot_blocks = [[] for _ in range(self.n_slots)]
        self._slot_shared = np.zeros(self.n_slots, np.int32)  # blocks
        # pool telemetry for serving metrics
        self.low_watermark = self.pool.n_free

    # -- slot surface -------------------------------------------------------

    @property
    def n_free(self):
        return len(self._free)

    @property
    def n_active(self):
        return int(self.active.sum())

    @property
    def occupancy(self):
        return self.n_active / self.n_slots

    def alloc(self):
        if not self._free:
            return None
        slot = self._free.popleft()
        self.active[slot] = True
        self.cur_pos[slot] = 0
        return slot

    def free(self, slot):
        """Evict a slot: every block reference it holds (shared prefix
        AND private tail/decode blocks) is dropped; blocks the radix
        still indexes stay resident for future sharers, the rest return
        to the pool. Device lines are NOT cleared — a freed block is
        only re-read after a later occupant overwrites it (causal
        bound + table ordering)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        for b in self._slot_blocks[slot]:
            self.pool.deref(b)
        self._slot_blocks[slot] = []
        self._slot_shared[slot] = 0
        self.block_tables[slot, :] = TRASH_BLOCK
        self._free.append(slot)

    def nbytes(self):
        return 2 * self.kc.numel() * self.kc.element_size()

    # -- paged admission ---------------------------------------------------

    def free_tokens(self, include_evictable=True):
        """Admission headroom in token lines: free blocks plus (by
        default) radix-held blocks reclaimable on demand."""
        n = self.pool.n_free
        if include_evictable:
            n += self.radix.evictable_blocks(self.pool)
        return n * self.block_size

    def _alloc_or_evict(self):
        b = self.pool.alloc()
        if b is None and self.radix.evict(self.pool, need=1):
            b = self.pool.alloc()
        if b is not None:
            self.low_watermark = min(self.low_watermark, self.pool.n_free)
        return b

    def admit(self, slot, prompt_ids, n_cover):
        """Wire slot block-table coverage for logical positions
        ``[0, n_cover)``: the longest radix-cached full-block prefix of
        ``prompt_ids`` is shared (refcounted, never written by this
        slot), the rest allocated privately. Returns
        ``(n_shared_tokens, cow_copy)`` or None when the pool cannot
        cover the request even after radix eviction (caller re-queues);
        ``cow_copy`` is True when a shared prefix ends mid-prompt so the
        partial tail block was privatized (copy-on-write recompute)."""
        assert not self._slot_blocks[slot], "slot already wired"
        shared = self.radix.match(prompt_ids)
        need_blocks = -(-int(n_cover) // self.block_size)
        shared = shared[:need_blocks]
        blocks = []
        for b in shared:
            self.pool.ref(b)
            blocks.append(b)
        ok = True
        for _ in range(need_blocks - len(shared)):
            b = self._alloc_or_evict()
            if b is None:
                ok = False
                break
            blocks.append(b)
        if not ok:
            for b in blocks:
                self.pool.deref(b)
            return None
        self._slot_blocks[slot] = blocks
        self._slot_shared[slot] = len(shared)
        self.block_tables[slot, :] = TRASH_BLOCK
        self.block_tables[slot, :len(blocks)] = blocks
        n_shared_tokens = len(shared) * self.block_size
        cow = bool(shared) and n_shared_tokens < len(prompt_ids)
        return n_shared_tokens, cow

    def ensure(self, slot, pos):
        """Guarantee a writable block exists for logical position
        ``pos`` (decode growth). True on success, False when the pool is
        exhausted (caller preempts someone)."""
        idx = int(pos) // self.block_size
        if idx < len(self._slot_blocks[slot]):
            return True
        assert idx == len(self._slot_blocks[slot]), "non-contiguous growth"
        b = self._alloc_or_evict()
        if b is None:
            return False
        self._slot_blocks[slot].append(b)
        self.block_tables[slot, idx] = b
        return True

    def commit_prefix(self, slot, prompt_ids):
        """After a slot's prefill fully completes, publish its prompt's
        full blocks into the radix index so later requests share them."""
        n_full = len(prompt_ids) // self.block_size
        return self.radix.insert(prompt_ids,
                                 self._slot_blocks[slot][:n_full],
                                 self.pool)

    def check_refcounts(self):
        """Pool/table/radix invariant: every block's refcount equals the
        number of slots holding it plus one if the radix indexes it, and
        free-list membership is exact. Used by chaos verdicts/tests."""
        want = np.zeros(self.pool.n_blocks, np.int32)
        want[TRASH_BLOCK] = 1
        for blocks in self._slot_blocks:
            for b in blocks:
                want[b] += 1
        for n in self.radix._nodes():
            want[n.block] += 1
        if not np.array_equal(want, self.pool.refcount):
            return False
        free = set(self.pool._free)
        return all((self.pool.refcount[b] == 0) == (b in free)
                   for b in range(1, self.pool.n_blocks))

    def pool_stats(self):
        return {"n_blocks": self.pool.n_blocks,
                "block_size": self.block_size,
                "blocks_free": self.pool.n_free,
                "blocks_used": self.pool.n_used,
                "blocks_low_watermark": int(self.low_watermark),
                "radix_nodes": self.radix.n_nodes,
                "pool_occupancy_now": round(
                    self.pool.n_used / max(1, self.pool.n_blocks - 1), 4)}
