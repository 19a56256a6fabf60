"""Paged KV-cache pool: host-side free-list allocator + block tables (the
port's copy of ``llmtrain_tpu/serving/paged_kv.py``, pure Python).

The device-side cache is a pool of ``num_blocks`` fixed-size blocks of
``block_tokens`` positions each, owned per layer by the paged decode
model (models/gpt.py ``_paged_decode_attention``). THIS module owns the
host-side accounting that makes the pool safe to share between N
in-flight sequences (the vLLM PagedAttention layout, PAPERS.md MinT —
multiplexing many requests onto one accelerator is where serving
throughput/$ is decided):

* a **free list** of physical block ids (block 0 is the reserved null
  block — padded block-table entries point at it and its contents are
  garbage by construction, never read by a live query);
* **admission-time budget reservation**: a sequence reserves its
  worst-case block count (``ceil((prompt+max_new)/block_tokens)``) before
  joining the batch, so mid-flight allocation can never fail — the
  continuous scheduler admits only what the pool can finish;
* **lazy physical allocation**: reserved blocks are bound to physical ids
  only when the sequence actually reaches them, so pool occupancy tracks
  REAL cache bytes, not worst cases (the utilization gauge the serving
  telemetry exports);
* **content-addressed shared prefixes** (opt-in): a FULL block whose
  positions hold a pure function of the token prefix is registered under
  the chain hash ``h_i = sha256(h_{i-1} || tokens[i*bt:(i+1)*bt])`` and
  later requests with the same prefix bind it read-only (refcounted)
  instead of re-prefilling. The common system-prompt case prefills once
  per replica. A block whose prefix only PARTIALLY matches is bound
  shared too, then copy-on-write'd the moment the divergent token needs
  to be written. Released shared blocks park in an LRU "evictable" set —
  still cached, reclaimed on demand — so reuse can only REDUCE physical
  block need and the reservation invariant survives: for every table,
  shared binds consume reservation slots without consuming free blocks,
  hence ``free + evictable >= outstanding unbound reservations`` always.

Pure host-side Python (no torch): allocation is scheduler-thread-only and
lock-free here — the scheduler serializes all calls.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Sequence

NULL_BLOCK = 0


def hash_token_block(parent: str, tokens: Sequence[int]) -> str:
    """Chain hash of one full token block: position-aware by construction
    (the parent hash encodes everything before this block), so equal
    hashes mean equal K/V content for a deterministic model."""
    h = hashlib.sha256()
    h.update(parent.encode("ascii"))
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode("ascii"))
    return h.hexdigest()


def chain_hashes(prompt_ids: Sequence[int], block_tokens: int) -> list[str]:
    """Chain hashes of every FULL block of ``prompt_ids`` (the trailing
    partial block has no hash — only complete blocks are content-stable)."""
    out: list[str] = []
    parent = ""
    for i in range(len(prompt_ids) // block_tokens):
        parent = hash_token_block(
            parent, prompt_ids[i * block_tokens : (i + 1) * block_tokens]
        )
        out.append(parent)
    return out


@dataclass
class PrefixMatch:
    """Outcome of a prefix-cache lookup for one prompt."""

    full_blocks: list[int] = field(default_factory=list)  # physical ids
    partial_block: int | None = None  # physical id, partially matching
    partial_tokens: int = 0  # tokens matched inside partial_block
    matched_tokens: int = 0  # total prompt tokens covered

    @property
    def hit(self) -> bool:
        return self.matched_tokens > 0


@dataclass
class _CacheEntry:
    """Host-side record of one cached (shareable) physical block."""

    hash: str
    parent: str
    tokens: tuple[int, ...]
    refs: int = 0
    # Set on hot-swap: content was computed under superseded params; no
    # new binds, and the block frees (not parks) when its refs drain.
    stale: bool = False


@dataclass
class BlockTable:
    """One sequence's logical→physical block mapping."""

    reserved: int  # admission-time budget (blocks), upper bound
    block_tokens: int
    blocks: list[int] = field(default_factory=list)  # physical ids, in order
    # Leading run of `blocks` that is SHARED (refcounted, read-only).
    # Everything past it is exclusively owned. COW and registration
    # preserve the leading-run shape.
    shared: int = 0

    @property
    def allocated(self) -> int:
        return len(self.blocks)

    def padded(self, max_blocks: int) -> list[int]:
        """Physical ids padded with the null block to ``max_blocks``
        (the fixed-width table the paged decode step consumes)."""
        if len(self.blocks) > max_blocks:
            raise ValueError(
                f"table holds {len(self.blocks)} blocks > max_blocks "
                f"({max_blocks})"
            )
        return self.blocks + [NULL_BLOCK] * (max_blocks - len(self.blocks))


class PagedKVPool:
    """Free-list allocator over the physical block pool.

    Invariant: ``available`` (unreserved budget) never exceeds the
    reclaimable supply (free list + evictable cached blocks), so a
    reserved sequence's :meth:`grow` cannot fail — admission control
    (:meth:`try_reserve`) is the only place that says no.
    """

    def __init__(
        self,
        num_blocks: int,
        block_tokens: int,
        *,
        prefix_cache: bool = False,
    ) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the null block), "
                f"got {num_blocks}"
            )
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        # LIFO free list, block 0 excluded (null block).
        self._free = list(range(num_blocks - 1, 0, -1))
        self._available = num_blocks - 1  # capacity minus live reservations
        self._tables: set[int] = set()  # live table object ids (double-free guard)
        self.peak_allocated = 0
        self.peak_reserved = 0
        # ---- content-addressed prefix cache (docstring: shared prefixes)
        self.prefix_cache_enabled = bool(prefix_cache)
        self._index: dict[str, int] = {}  # chain hash -> physical block
        self._entries: dict[int, _CacheEntry] = {}  # physical block -> entry
        self._children: dict[str, list[int]] = {}  # parent hash -> blocks
        self._evictable: OrderedDict[int, None] = OrderedDict()  # refs==0, LRU
        self.prefix_hits = 0  # blocks bound shared instead of re-prefilled
        self.prefix_queries = 0
        self.prefix_hit_queries = 0  # queries that bound >= 1 cached block
        self.prefix_tokens_reused = 0
        self.prefix_evictions = 0
        self.cow_copies = 0
        # Optional event observer ``(name, args) -> None`` wired by the
        # scheduler to its timeline: pool-level events (evictions, COW,
        # cache invalidation) that explain request latency but have no
        # request of their own. Scheduler-thread-only, like every other
        # pool mutation; observer failures never reach the pool.
        self.observer: Any = None

    def _observe(self, name: str, **args: Any) -> None:
        if self.observer is None:
            return
        try:
            self.observer(name, args)
        except Exception:  # noqa: BLE001 — telemetry must not break paging
            pass

    # ------------------------------------------------------------- sizing

    def blocks_needed(self, total_tokens: int) -> int:
        """Worst-case blocks for a sequence of ``total_tokens`` positions."""
        return max(1, -(-int(total_tokens) // self.block_tokens))

    # --------------------------------------------------------- allocation

    @property
    def available_blocks(self) -> int:
        """Unreserved budget — what admission control may still promise."""
        return self._available

    @property
    def allocated_blocks(self) -> int:
        """Blocks live RIGHT NOW (bound to a sequence); parked cached
        blocks are reclaimable supply, not live occupancy."""
        return (self.num_blocks - 1) - len(self._free) - len(self._evictable)

    @property
    def cached_blocks(self) -> int:
        return len(self._evictable)

    def try_reserve(self, total_tokens: int) -> BlockTable | None:
        """Admit a sequence of ``total_tokens`` worst-case positions.

        Returns its table (budget reserved, nothing bound yet) or None
        when the pool cannot guarantee completion — the scheduler then
        leaves the request queued instead of admitting work it would
        have to evict mid-flight.
        """
        need = self.blocks_needed(total_tokens)
        if need > self._available:
            return None
        self._available -= need
        table = BlockTable(reserved=need, block_tokens=self.block_tokens)
        self._tables.add(id(table))
        self.peak_reserved = max(
            self.peak_reserved, (self.num_blocks - 1) - self._available
        )
        return table

    def _take_block(self) -> int:
        """Pop a physical block: free list first, then evict the LRU
        cached block. Cannot fail inside a reservation (class invariant)."""
        if self._free:
            return self._free.pop()
        if self._evictable:
            blk, _ = self._evictable.popitem(last=False)
            self._forget_entry(blk)
            self.prefix_evictions += 1
            self._observe("evict", block=blk, cached_blocks=len(self._evictable))
            return blk
        raise RuntimeError(
            "paged KV pool exhausted inside a reservation — accounting bug"
        )

    def _forget_entry(self, blk: int) -> None:
        ent = self._entries.pop(blk)
        self._index.pop(ent.hash, None)
        siblings = self._children.get(ent.parent)
        if siblings is not None:
            try:
                siblings.remove(blk)
            except ValueError:
                pass
            if not siblings:
                del self._children[ent.parent]

    def grow(self, table: BlockTable, upto_tokens: int) -> None:
        """Bind physical blocks so positions < ``upto_tokens`` are backed.

        Cannot fail within the reservation (the invariant admission
        bought); exceeding it is a scheduler bug and raises.
        """
        if id(table) not in self._tables:
            raise ValueError("grow() on a released or foreign block table")
        need = self.blocks_needed(upto_tokens)
        if need > table.reserved:
            raise ValueError(
                f"sequence needs {need} blocks > its reservation "
                f"({table.reserved}) — admission sizing bug"
            )
        while table.allocated < need:
            table.blocks.append(self._take_block())
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)

    def release(self, table: BlockTable) -> None:
        """Retire a sequence: free its owned blocks, unpin its shared
        ones (refs drain to the evictable LRU), return its budget."""
        if id(table) not in self._tables:
            raise ValueError("release() on a released or foreign block table")
        self._tables.remove(id(table))
        for i, blk in enumerate(table.blocks):
            if i < table.shared:
                ent = self._entries.get(blk)
                if ent is None or ent.refs <= 0:
                    raise ValueError(
                        f"refcount double-free on shared block {blk}"
                    )
                ent.refs -= 1
                if ent.refs == 0:
                    if ent.stale:
                        self._forget_entry(blk)
                        self._free.append(blk)
                    else:
                        self._evictable[blk] = None  # MRU end
            else:
                self._free.append(blk)
        self._available += table.reserved
        table.blocks = []
        table.reserved = 0
        table.shared = 0

    # ------------------------------------------------------ prefix sharing

    def match_prefix(self, prompt_ids: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``prompt_ids``: a chain of full
        blocks, optionally extended by one partially-matching block.

        Matching is capped at ``len(prompt_ids) - 1`` tokens — at least
        one prompt token must remain for prefill, because sampling the
        first output token needs a real forward pass.
        """
        match = PrefixMatch()
        if not self.prefix_cache_enabled or len(prompt_ids) < 2:
            return match
        self.prefix_queries += 1
        bt = self.block_tokens
        limit = len(prompt_ids) - 1
        parent = ""
        for i in range(limit // bt):
            h = hash_token_block(parent, prompt_ids[i * bt : (i + 1) * bt])
            blk = self._index.get(h)
            if blk is None:
                break
            parent = h
            match.full_blocks.append(blk)
        # One partially-matching continuation block: shares the first
        # j < bt tokens, COW'd before the divergent token is written.
        start = len(match.full_blocks) * bt
        rest = [int(t) for t in prompt_ids[start:limit]]
        if rest:
            best_j, best_blk = 0, None
            for blk in self._children.get(parent, ()):
                ent = self._entries[blk]
                j = 0
                for a, b in zip(ent.tokens, rest):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best_j, best_blk = j, blk
            if best_blk is not None:
                match.partial_block = best_blk
                match.partial_tokens = best_j
        match.matched_tokens = start + match.partial_tokens
        return match

    def bind_prefix(self, table: BlockTable, match: PrefixMatch) -> int:
        """Bind a match's blocks into a freshly-reserved table (shared,
        refcounted). Returns the number of prompt tokens now backed by
        cached K/V. Must run before any :meth:`grow` on the table."""
        if id(table) not in self._tables:
            raise ValueError("bind_prefix() on a released or foreign table")
        if table.blocks:
            raise ValueError("bind_prefix() must precede grow()")
        if not match.hit:
            return 0
        shared = list(match.full_blocks)
        if match.partial_block is not None:
            shared.append(match.partial_block)
        if len(shared) > table.reserved:
            raise ValueError(
                f"prefix match spans {len(shared)} blocks > reservation "
                f"({table.reserved}) — matching must be capped by the prompt"
            )
        for blk in shared:
            ent = self._entries[blk]
            if ent.stale:
                raise ValueError(f"bind_prefix() on stale block {blk}")
            if ent.refs == 0:
                self._evictable.pop(blk, None)  # pin: no longer reclaimable
            ent.refs += 1
            table.blocks.append(blk)
        table.shared = len(shared)
        self.prefix_hits += len(shared)
        self.prefix_hit_queries += 1
        self.prefix_tokens_reused += match.matched_tokens
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)
        return match.matched_tokens

    def cow_last_shared(self, table: BlockTable) -> tuple[int, int]:
        """Copy-on-write the table's last shared block (the partially-
        matched one): allocate a private destination, unpin the source,
        and hand back ``(src, dst)`` for the device-side copy.

        CONTRACT: the caller must issue the device copy before the next
        pool mutation — once unpinned, the source is evictable.
        """
        if id(table) not in self._tables:
            raise ValueError("cow_last_shared() on a released or foreign table")
        if table.shared == 0:
            raise ValueError("cow_last_shared() on a table with no shared blocks")
        idx = table.shared - 1
        src = table.blocks[idx]
        # Take dst while src is still pinned so eviction cannot grab src.
        dst = self._take_block()
        ent = self._entries[src]
        if ent.refs <= 0:
            raise ValueError(f"refcount underflow on shared block {src}")
        ent.refs -= 1
        if ent.refs == 0:
            if ent.stale:
                self._forget_entry(src)
                self._free.append(src)
            else:
                self._evictable[src] = None
        table.blocks[idx] = dst
        table.shared -= 1
        self.cow_copies += 1
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)
        self._observe("cow", src=src, dst=dst)
        return src, dst

    def register_prefix(
        self, table: BlockTable, prompt_ids: Sequence[int]
    ) -> int:
        """After a prompt is fully prefilled, publish its full blocks into
        the content index so later requests can share them. Registered
        blocks convert from owned to shared (this table holds one ref);
        registration stops at the first block already indexed (an
        identical twin serves future lookups) so the table's shared run
        stays a contiguous prefix. Returns blocks newly registered."""
        if not self.prefix_cache_enabled:
            return 0
        if id(table) not in self._tables:
            raise ValueError("register_prefix() on a released or foreign table")
        bt = self.block_tokens
        nfull = len(prompt_ids) // bt  # immutable from now on: decode
        # writes land at positions >= len(prompt_ids), never below nfull*bt
        hashes = chain_hashes(prompt_ids[: nfull * bt], bt)
        registered = 0
        for i in range(table.shared, nfull):
            h = hashes[i]
            if h in self._index:
                break  # identical content already published
            blk = table.blocks[i]
            parent = hashes[i - 1] if i > 0 else ""
            self._index[h] = blk
            self._entries[blk] = _CacheEntry(
                hash=h,
                parent=parent,
                tokens=tuple(int(t) for t in prompt_ids[i * bt : (i + 1) * bt]),
                refs=1,
            )
            self._children.setdefault(parent, []).append(blk)
            table.shared += 1
            registered += 1
        return registered

    def invalidate_prefix_cache(self) -> int:
        """Hot-swap barrier: cached K/V was computed under superseded
        params. Parked blocks free immediately; live shared blocks are
        marked stale (their in-flight readers finish on the old params)
        and free — not park — when their refs drain. Returns blocks
        invalidated."""
        flushed = len(self._evictable)
        while self._evictable:
            blk, _ = self._evictable.popitem(last=False)
            self._forget_entry(blk)
            self._free.append(blk)
        for blk in list(self._entries):
            ent = self._entries[blk]
            ent.stale = True
            self._index.pop(ent.hash, None)
            siblings = self._children.get(ent.parent)
            if siblings is not None:
                try:
                    siblings.remove(blk)
                except ValueError:
                    pass
                if not siblings:
                    del self._children[ent.parent]
            flushed += 1
        if flushed:
            self._observe("prefix_invalidated", blocks=flushed)
        return flushed

    # ------------------------------------------------------------ telemetry

    def stats(self) -> dict[str, float]:
        capacity = self.num_blocks - 1
        out = {
            "capacity_blocks": capacity,
            "block_tokens": self.block_tokens,
            "allocated_blocks": self.allocated_blocks,
            "reserved_blocks": capacity - self._available,
            "utilization": round(self.allocated_blocks / capacity, 4),
            "peak_allocated_blocks": self.peak_allocated,
            "peak_reserved_blocks": self.peak_reserved,
            "active_sequences": len(self._tables),
        }
        if self.prefix_cache_enabled:
            out["prefix_cached_blocks"] = self.cached_blocks
            out["prefix_hits"] = self.prefix_hits
            out["prefix_queries"] = self.prefix_queries
            out["prefix_hit_queries"] = self.prefix_hit_queries
            out["prefix_tokens_reused"] = self.prefix_tokens_reused
            out["prefix_evictions"] = self.prefix_evictions
            # Fraction of lookups that bound at least one cached block
            # (prefix_hits counts BLOCKS, so it is not the numerator here).
            out["prefix_hit_rate"] = round(
                self.prefix_hit_queries / max(1, self.prefix_queries), 4
            )
            out["cow_copies"] = self.cow_copies
        return out


__all__ = [
    "NULL_BLOCK",
    "BlockTable",
    "PagedKVPool",
    "PrefixMatch",
    "chain_hashes",
    "hash_token_block",
]
