"""Paged KV-cache manager: ref-counted pages + prefix sharing + free list.

Replaces per-request ring buffers with a pool of fixed-size pages shared by
every decode slot (vLLM's PagedAttention layout, collapsed to the needs of
this engine).  The device side — per-unit pools of shape ``(n_units,
n_pages, page_size, Hkv, hd)`` plus per-slot ``block_tables``/``pos`` —
comes from :func:`repro_torch.models.transformer.init_paged_cache`; this class
owns the *host* side: which physical page backs which logical block of
which slot, which pages are free, and — new in this layer — which pages
hold a **cached prompt prefix** that future requests can map read-only
instead of recomputing.

Prefix sharing
--------------
Pages are immutable once full, and a page's KV rows depend only on the
token ids of the whole prefix up to and including that page (RoPE is
applied at absolute positions, and the layout is linear: block ``j`` holds
positions ``[j*ps, (j+1)*ps)``).  So a trie keyed on page-sized token
chunks indexes every cached prefix: ``admit_with_prefix`` walks it and maps
the longest cached prefix onto shared read-only pages (refcount + 1 each),
allocating private pages only for the uncached suffix.  When the match
ends inside a page (the common system prompt is rarely page-aligned), the
shared page cannot be mapped directly — the suffix prefill would write
into it — so the manager emits a **copy-on-write** spec: the engine copies
the matched rows into the slot's private page device-side and only then
writes the suffix behind them.

The trie itself holds one reference per indexed page, so a released
request's prefix pages *survive* until evicted — this is what makes
preemption cheap: a preempted request re-queued with its generated tokens
folded into the prompt finds nearly all of its pages still cached and
prefills only the tail.  When free pages run short, least-recently-used
trie leaves are evicted (leaf-first keeps the index prefix-closed); a page
is returned to the free list exactly when its last holder — slot or trie —
lets go.

Host-memory tier (two-tier hierarchy)
-------------------------------------
With ``host_tier=True`` (and device callbacks attached via
:meth:`attach_tier`), eviction of a trie-only page becomes *demotion*:
the page's KV rows are fetched to a host-memory blob (numpy), the device
page is freed, and the trie node survives with ``page = HOST_PAGE`` — a
later prefix hit *promotes* it back onto a fresh device page instead of
recomputing the prefill.  Transfers are charged into a modelled energy
ledger (``bytes x transfer_j_per_byte``, read by the engine per chunk),
and a page is only demoted when the round trip is cheaper than
recomputing its rows (``_should_demote``); otherwise it is dropped as
before.  A demoted page lives in exactly one tier: its node holds no
device refcount, contributes nothing to ``n_evictable``, and costs one
device page of *headroom* when a prefix match wants it back — which is
exactly how ``can_admit_with_prefix`` accounts for it.

Invariants the decode path relies on:

  * pages 0..n_slots-1 are reserved per-slot *scratch* pages; a free slot's
    whole table row points at its scratch page, so parked slots can keep
    executing (write + attend on scratch garbage, output discarded) without
    any validity branch in the jitted loop;
  * a live slot's table rows beyond its allocation also point at scratch,
    so within-chunk overrun past a request's budget stays contained;
  * distinct slots never WRITE the same non-scratch page: shared pages are
    mapped strictly below each holder's write frontier (the suffix starts
    at or past the shared prefix), so the per-layer scatter in
    ``gqa_decode_paged`` / ``commit_spec_paged`` never collides across the
    batch;
  * ``refcount[p]`` equals the number of holders (slots mapping p + one if
    the trie indexes p); the free list is exactly the zero-refcount pages.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class CopySpec:
    """Copy-on-write order emitted by ``admit_with_prefix`` for a partial
    page match: the engine must copy rows ``0..n_rows-1`` of ``src_page``
    into ``dst_page`` device-side, then call ``copy_done(src_page)`` to
    drop the read hold protecting the source from eviction-reuse."""
    src_page: int
    dst_page: int
    n_rows: int


# sentinel for a trie node whose KV lives in the host tier, not on device
HOST_PAGE = -2


def _np_dtype(name: str) -> np.dtype:
    """np.dtype by name, including the ml_dtypes extension types (numpy
    does not know "bfloat16" natively)."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _blob_to_json(arr: np.ndarray) -> dict:
    a = np.asarray(arr)
    # floats round-trip exactly through their bit pattern, not repr
    bits = a.view(np.uint8)
    return {"data": bits.ravel().tolist(), "dtype": str(a.dtype),
            "shape": list(a.shape)}


def _blob_from_json(blob: dict) -> np.ndarray:
    dt = _np_dtype(blob["dtype"])
    a = np.asarray(blob["data"], np.uint8).view(dt)
    return a.reshape(blob["shape"])


class _TrieNode:
    """One full page of cached prefix: ``tokens`` (page_size ids), the
    physical page holding their KV, and children keyed on the next page's
    token bytes.  A demoted node has ``page == HOST_PAGE`` and carries the
    page's rows in ``host_data`` (unit/key -> numpy blob) instead."""
    __slots__ = ("key", "tokens", "page", "parent", "children", "last_used",
                 "host_data")

    def __init__(self, key, tokens, page, parent):
        self.key = key
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: dict[bytes, _TrieNode] = {}
        self.last_used = 0
        self.host_data: dict | None = None


class PagedKVCache:
    """Host-side page allocator for the paged decode cache."""

    def __init__(self, cfg, *, n_slots: int, page_size: int, max_len: int,
                 n_pages: int | None = None, dtype: str = "bfloat16",
                 host_tier: bool = False, host_pages: int | None = None,
                 transfer_j_per_byte: float = 1e-9,
                 recompute_j_per_token: float | None = None):
        blockers = tfm.paged_cache_blockers(cfg)
        if blockers:
            raise ValueError(f"{cfg.name}: paged KV cache blocked by "
                             f"{blockers[0]}")
        self.cfg = cfg
        # Families whose every cache group is slot-indexed (pure-SSM state
        # slots, all-windowed private rings, the hybrid shared buffer) have
        # no block-table-backed pool: the manager still owns slot parking,
        # but page allocation is a no-op and admission is purely a
        # slot-availability question.
        self.tables_active = self._has_table_group(cfg)
        self.n_slots = int(n_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.max_blocks = -(-self.max_len // self.page_size)
        if n_pages is None:
            # full provisioning: every slot can hold max_len, plus scratch
            n_pages = self.n_slots * self.max_blocks + self.n_slots
        self.n_pages = int(n_pages)
        self.dtype = dtype
        # scratch page s backs every unallocated block of slot s
        self.tables = np.arange(self.n_slots, dtype=np.int32)[:, None].repeat(
            self.max_blocks, axis=1)
        self.free: deque[int] = deque(range(self.n_slots, self.n_pages))
        self.allocated: dict[int, list[int]] = {}   # slot -> mapped pages
        self.refcount = np.zeros((self.n_pages,), np.int64)
        self._root = _TrieNode(None, None, -1, None)
        self._clock = 0
        self._copy_holds: dict[int, int] = {}       # page -> pending holds
        # Pages pulled from circulation by verify_invariants(repair=True):
        # corrupted metadata, no legitimate holder.  Never re-enter the
        # free list — capacity degrades gracefully instead of serving a
        # poisoned page.
        self.quarantined: set[int] = set()
        # host tier: demote-instead-of-evict for trie-only pages.  The
        # device transfer callbacks arrive via attach_tier (the manager is
        # layout-agnostic); until then demotion silently degrades to plain
        # eviction even with host_tier=True.
        self.host_tier = bool(host_tier)
        self.host_pages = None if host_pages is None else int(host_pages)
        self.transfer_j_per_byte = float(transfer_j_per_byte)
        self.recompute_j_per_token = recompute_j_per_token if \
            recompute_j_per_token is None else float(recompute_j_per_token)
        self._fetch_page = None       # page -> {unit/key: np blob}   (D2H)
        self._restore_page = None     # (page, blob) -> None          (H2D)
        self._page_bytes = 0          # device bytes of one page (all units)
        self.transfer_bytes_d2h = 0
        self.transfer_bytes_h2d = 0
        self.transfer_j = 0.0
        self.n_demotions = 0
        self.n_promotions = 0

    @staticmethod
    def _has_table_group(cfg) -> bool:
        """Does any cache group ride the shared page pools (vs per-slot
        state slots / private windowed rings / the hybrid shared buffer)?"""
        if cfg.first_dense_layers:
            return True
        if cfg.uses_ssm:            # ssm + hybrid: every sub is state-slot
            return False
        if cfg.use_mla:             # latent pool rides the main tables
            return True
        return any(cfg.window_for_layer(i) == 0
                   for i in range(tfm.unit_size(cfg)))

    # -- device side --------------------------------------------------------
    def make_cache(self, device):
        """Fresh zero-filled cache dict matching this manager, on
        ``device`` (a resolved ``torch.device``)."""
        return tfm.init_paged_cache(self.cfg, self.n_slots, self.n_pages,
                                    self.page_size, self.max_blocks,
                                    dtype=self.dtype, device=device)

    # -- host tier ----------------------------------------------------------
    def attach_tier(self, fetch_page, restore_page, page_bytes: int) -> None:
        """Wire the device transfer callbacks: ``fetch_page(page)`` returns
        the page's rows as a host blob (D2H), ``restore_page(page, blob)``
        writes a blob back into a device page (H2D), ``page_bytes`` is the
        device footprint of one page across every unit/layer (the quantity
        the transfer-energy model charges per direction)."""
        self._fetch_page = fetch_page
        self._restore_page = restore_page
        self._page_bytes = int(page_bytes)

    @property
    def _tier_ready(self) -> bool:
        return self.host_tier and self._fetch_page is not None

    def n_host_used(self) -> int:
        """Demoted pages currently parked in the host tier."""
        return sum(1 for node in self._all_nodes()
                   if node.host_data is not None)

    def _should_demote(self) -> bool:
        """Demote-vs-evict energy rule: page out only when the full round
        trip (D2H now + H2D on the future hit) costs less than recomputing
        the page's rows from tokens.  With no recompute price configured,
        transfer is assumed cheap (PCIe ~GB/s vs a prefill sweep) and cold
        pages always demote."""
        if self.recompute_j_per_token is None:
            return True
        round_trip = 2 * self._page_bytes * self.transfer_j_per_byte
        return round_trip <= self.page_size * self.recompute_j_per_token

    def _charge_transfer(self, n_bytes: int, *, h2d: bool) -> None:
        if h2d:
            self.transfer_bytes_h2d += n_bytes
        else:
            self.transfer_bytes_d2h += n_bytes
        self.transfer_j += n_bytes * self.transfer_j_per_byte

    def _demote(self, node: _TrieNode) -> None:
        """Page out a trie-only node: fetch its rows to host memory, free
        the device page, keep the trie entry alive at ``HOST_PAGE``."""
        node.host_data = self._fetch_page(node.page)
        self._charge_transfer(self._page_bytes, h2d=False)
        self._unhold(node.page)
        node.page = HOST_PAGE
        self.n_demotions += 1

    def _promote(self, node: _TrieNode, protect: set[int] | None = None) \
            -> bool:
        """Page a demoted node back onto a fresh device page (reclaiming
        one if the free list is dry — ``protect`` guards the other nodes
        of an in-flight prefix match from being cannibalised).  Returns
        False when no device page can be found; the node stays demoted."""
        if not self.free and not self._reclaim(1, protect=protect):
            return False
        page = self._take_free()            # refcount 1 = the trie's hold
        self._restore_page(page, node.host_data)
        self._charge_transfer(self._page_bytes, h2d=True)
        node.page = page
        node.host_data = None
        self.n_promotions += 1
        return True

    # -- refcount plumbing --------------------------------------------------
    def _hold(self, page: int) -> None:
        self.refcount[page] += 1

    def _unhold(self, page: int) -> None:
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise AssertionError(f"page {page}: refcount underflow")
        if self.refcount[page] == 0 and page not in self.quarantined:
            self.free.append(page)

    def _take_free(self) -> int:
        page = self.free.popleft()
        self._hold(page)
        return page

    # -- trie ---------------------------------------------------------------
    def _chunks(self, tokens: np.ndarray):
        """tokens split into full page_size chunks (bytes key + array)."""
        ps = self.page_size
        t = np.ascontiguousarray(np.asarray(tokens))
        for j in range(len(t) // ps):
            chunk = t[j * ps:(j + 1) * ps]
            yield chunk.tobytes(), chunk

    def _match(self, tokens: np.ndarray):
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` (at
        least one token is always left to prefill so its logits exist).
        Returns (full_nodes, partial) where partial is (node, n_rows) for a
        match ending inside a page, or None."""
        t = np.asarray(tokens)
        max_share = len(t) - 1
        node, full = self._root, []
        for key, chunk in self._chunks(t):
            if (len(full) + 1) * self.page_size > max_share:
                break
            child = node.children.get(key)
            if child is None:
                break
            full.append(child)
            node = child
        off = len(full) * self.page_size
        rem = min(self.page_size, max_share - off)
        partial = None
        if rem > 0:
            want = np.asarray(t[off:off + rem]).reshape(rem, -1)
            best, best_n = None, 0
            for child in node.children.values():
                have = np.asarray(child.tokens).reshape(self.page_size, -1)
                eq = np.all(have[:rem] == want, axis=1)
                n = int(eq.argmin()) if not eq.all() else rem
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                partial = (best, best_n)
        return full, partial

    def _leaves(self):
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and not node.children:
                out.append(node)
            stack.extend(node.children.values())
        return out

    def _evict_one(self, protect: set[int] | None = None) -> bool:
        """Surrender one trie-held device page.

        When the host tier is live and the energy rule favours transfer,
        the LRU *trie-only* node anywhere in the trie — leaf or interior —
        *demotes*: its rows page out, the device page frees, the node
        survives at ``HOST_PAGE``.  Demotion keeps the trie structurally
        intact, so leaf-first does not apply; residency of a prefix may be
        a patchwork across tiers and promotion restores matched nodes one
        by one.  Otherwise the classic path drops the LRU leaf (leaf-first
        keeps the *index* prefix-closed), freeing its page iff the trie was
        the last holder; and when only demoted leaves remain, the LRU one
        is dropped outright if that can eventually expose a resident page
        (its host blob dies — the tier is a cache, not an archive).
        ``protect`` exempts nodes of an in-flight prefix match.  Returns
        False when nothing can go."""
        protect = protect or set()
        if (self._tier_ready and self._should_demote()
                and (self.host_pages is None
                     or self.n_host_used() < self.host_pages)):
            cands = [n for n in self._all_nodes()
                     if id(n) not in protect and n.page >= 0
                     and self.refcount[n.page] == 1]
            if cands:
                self._demote(min(cands, key=lambda n: n.last_used))
                return True
        leaves = [n for n in self._leaves() if id(n) not in protect]
        resident = [n for n in leaves if n.page >= 0]
        if resident:
            victim = min(resident, key=lambda n:
                         (self.refcount[n.page] > 1, n.last_used))
            del victim.parent.children[victim.key]
            self._unhold(victim.page)
            return True
        # no resident leaf: dropping a demoted leaf frees no device page
        # directly, but may expose a resident interior node as a new leaf —
        # worth it only if such a node exists at all
        demoted = [n for n in leaves if n.host_data is not None]
        if demoted and self.n_evictable() > 0:
            victim = min(demoted, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            victim.host_data = None
            return True
        return False

    def _reclaim(self, n_pages: int,
                 protect: set[int] | None = None) -> bool:
        """Evict/demote trie entries until at least ``n_pages`` are free."""
        while len(self.free) < n_pages:
            if not self._evict_one(protect=protect):
                return False
        return True

    def n_evictable(self) -> int:
        """Pages the trie could surrender (trie is their only holder).
        Demoted nodes hold no device page and count for nothing here."""
        count, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root and node.page >= 0 \
                    and self.refcount[node.page] == 1:
                count += 1
            stack.extend(node.children.values())
        return count

    # -- allocation ---------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        if not self.tables_active:      # no pools: slots are the only gate
            return True
        return self.pages_for(n_tokens) <= len(self.free) + self.n_evictable()

    def can_admit_with_prefix(self, tokens: np.ndarray,
                              n_tokens: int) -> bool:
        """Like ``can_admit`` but crediting pages the prefix cache already
        holds for ``tokens`` — sharing raises admissible concurrency.
        Matched pages are about to be *held*, not freed, so they must not
        double-count as evictable headroom.  Two-tier accounting: a
        matched *demoted* page saves the prefill but still needs a fresh
        device page to promote onto (+1 to need, nothing reserved); a
        matched resident page whose only holder is the trie would have
        counted as evictable headroom, so it is subtracted back out."""
        if not self.tables_active:
            return True
        full, partial = self._match(tokens)
        n_blocks = self.pages_for(n_tokens)
        full = full[:n_blocks]
        need = n_blocks - len(full)
        need += sum(1 for node in full if node.page < 0)
        reserved = sum(1 for node in full
                       if node.page >= 0 and self.refcount[node.page] == 1)
        if partial is not None and len(full) < n_blocks:
            if partial[0].page < 0:
                need += 1
            elif self.refcount[partial[0].page] == 1:
                reserved += 1
        return need <= len(self.free) + self.n_evictable() - reserved

    def admit(self, slot: int, n_tokens: int) -> list[int]:
        """Allocate private pages covering ``n_tokens`` context positions
        for ``slot`` and point its table's leading blocks at them (no
        prefix sharing — the legacy entry point)."""
        pages = self._admit_pages(slot, self.pages_for(n_tokens), [])
        return pages

    def admit_with_prefix(self, slot: int, tokens: np.ndarray,
                          n_tokens: int) -> tuple[int, CopySpec | None]:
        """Map the longest cached prefix of ``tokens`` onto shared
        read-only pages and allocate private pages for the rest (covering
        ``n_tokens`` context positions total).

        Returns ``(matched_len, copy)``: the engine prefills only
        ``tokens[matched_len:]``.  ``copy`` (when the match ends inside a
        page) orders a device-side copy of the matched rows into the
        slot's first private page — copy-on-write, since the suffix
        prefill is about to write right behind them."""
        full, partial = self._match(tokens)
        n_blocks = self.pages_for(n_tokens)
        if len(full) > n_blocks:       # prompt cached deeper than the alloc
            full = full[:n_blocks]
            partial = None
        if partial is not None and len(full) >= n_blocks:
            partial = None
        # promote demoted matches back onto device pages, in prefix order;
        # the first failed promotion truncates the match there (the rest of
        # the prefix is unreachable without it).  The whole match is
        # protected from reclaim-eviction while promotions run.
        protect = {id(n) for n in full}
        if partial is not None:
            protect.add(id(partial[0]))
        usable = []
        for node in full:
            if node.page < 0 and not self._promote(node, protect=protect):
                partial = None
                break
            usable.append(node)
        else:
            if partial is not None and partial[0].page < 0 \
                    and not self._promote(partial[0], protect=protect):
                partial = None
        full = usable
        shared = []
        for node in full:
            self._hold(node.page)
            node.last_used = self._clock
            self._clock += 1
            shared.append(node.page)
        copy_src = None
        if partial is not None:
            node, rows = partial
            node.last_used = self._clock
            self._clock += 1
            # protect the source page from evict-and-reuse (the reclaim
            # inside _admit_pages included) until the engine has executed
            # the copy
            self._hold(node.page)
            self._copy_holds[node.page] = \
                self._copy_holds.get(node.page, 0) + 1
            copy_src = (node.page, rows)
        try:
            self._admit_pages(slot, n_blocks, shared)
        except ValueError:
            for p in shared:
                self._unhold(p)
            if copy_src is not None:
                self.copy_done(copy_src[0])
            raise
        matched = len(full) * self.page_size
        copy = None
        if copy_src is not None:
            copy = CopySpec(src_page=copy_src[0],
                            dst_page=int(self.tables[slot, len(full)]),
                            n_rows=copy_src[1])
            matched += copy_src[1]
        return matched, copy

    def _admit_pages(self, slot: int, n_blocks: int,
                     shared: list[int]) -> list[int]:
        if slot in self.allocated:
            raise ValueError(f"slot {slot} already holds an allocation")
        if not self.tables_active:
            assert not shared
            self.allocated[slot] = []
            self.tables[slot, :] = slot
            return []
        if n_blocks > self.max_blocks:
            raise ValueError(f"request needs {n_blocks} blocks > table "
                             f"width {self.max_blocks} "
                             f"(max_len {self.max_len})")
        need = n_blocks - len(shared)
        if not self._reclaim(need):
            raise ValueError(f"slot {slot}: {need} pages needed, "
                             f"{len(self.free)} free")
        pages = list(shared) + [self._take_free() for _ in range(need)]
        self.tables[slot, :] = slot                 # park the tail on scratch
        self.tables[slot, :n_blocks] = pages
        self.allocated[slot] = pages
        return pages

    def copy_done(self, src_page: int) -> None:
        """Release the read hold taken for a pending ``CopySpec``."""
        holds = self._copy_holds.get(src_page, 0)
        if holds <= 0:
            raise ValueError(f"page {src_page}: no pending copy hold")
        if holds == 1:
            del self._copy_holds[src_page]
        else:
            self._copy_holds[src_page] = holds - 1
        self._unhold(src_page)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``n_tokens`` context
        positions, evicting cached prefixes if needed.  Returns False when
        the pool cannot provide (the scheduler preempts someone)."""
        if slot not in self.allocated:
            raise ValueError(f"slot {slot} is not allocated")
        if not self.tables_active:
            return True
        need = self.pages_for(n_tokens)
        if need > self.max_blocks:
            raise ValueError(f"slot {slot}: {need} blocks > table width "
                             f"{self.max_blocks} (max_len {self.max_len})")
        cur = len(self.allocated[slot])
        if need <= cur:
            return True
        if not self._reclaim(need - cur):
            return False
        for j in range(cur, need):
            page = self._take_free()
            self.tables[slot, j] = page
            self.allocated[slot].append(page)
        return True

    def register_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Index ``slot``'s now-written pages in the prefix trie: every
        full page of ``tokens`` (KV must already be committed for all of
        them).  Pages already indexed for the same token prefix are left
        alone — the slot's duplicate stays private and dies with it."""
        if not self.tables_active:
            return
        n_blocks = len(self.allocated.get(slot, ()))
        node = self._root
        for j, (key, chunk) in enumerate(self._chunks(tokens)):
            if j >= n_blocks:
                break
            child = node.children.get(key)
            if child is None:
                page = int(self.tables[slot, j])
                child = _TrieNode(key, chunk.copy(), page, node)
                node.children[key] = child
                self._hold(page)
            child.last_used = self._clock
            self._clock += 1
            node = child

    def release(self, slot: int) -> None:
        """Drop ``slot``'s holds and park it.  Pages the trie still
        indexes survive as cached prefixes; the rest return to the free
        list."""
        for page in self.allocated.pop(slot, []):
            self._unhold(page)
        self.tables[slot, :] = slot

    # -- injection helper ---------------------------------------------------
    def inject_rows(self, slot: int, bucket_len: int, n_valid: int) -> np.ndarray:
        """Flat pool-row destinations for copying a prefill cache (padded to
        ``bucket_len``) into ``slot``'s pages.  Rows past ``n_valid`` (the
        real prompt length) map out of bounds and are dropped by the
        ``mode="drop"`` scatter."""
        rows = np.empty((bucket_len,), np.int32)
        for i in range(bucket_len):
            if i < n_valid:
                page = self.tables[slot, i // self.page_size]
                rows[i] = page * self.page_size + i % self.page_size
            else:
                rows[i] = self.n_pages * self.page_size    # dropped
        return rows

    # -- audit ----------------------------------------------------------------
    def _all_nodes(self) -> list[_TrieNode]:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            if node is not self._root:
                out.append(node)
            stack.extend(node.children.values())
        return out

    def _expected_holders(self) -> np.ndarray:
        """Ground-truth refcounts recomputed from the holder structures:
        slots mapping the page + trie nodes indexing it + pending copy
        holds.  ``refcount`` must equal this exactly."""
        exp = np.zeros((self.n_pages,), np.int64)
        for pages in self.allocated.values():
            for p in pages:
                exp[p] += 1
        for node in self._all_nodes():
            if 0 <= node.page < self.n_pages:
                exp[node.page] += 1
        for p, holds in self._copy_holds.items():
            exp[p] += holds
        return exp

    def verify_invariants(self, *, repair: bool = False) -> list[str]:
        """Audit the host metadata against the invariants the decode path
        relies on.  Returns the violations found (empty = clean).

        With ``repair=True`` the pool is additionally put back into a safe
        state: corrupted trie subtrees are dropped, refcounts of pages
        with legitimate holders are recomputed, and implicated pages with
        *no* holder are quarantined (withheld from the free list) rather
        than recirculated — serving degrades capacity instead of crashing
        or handing out a poisoned page.  Runs on engine restore and on
        demand (chaos drills).
        """
        violations: list[str] = []
        free_set = set(self.free)
        # 1. trie pages must be real, non-scratch, and not on the free
        # list; a node lives in exactly one tier — demoted (HOST_PAGE +
        # host blob) or resident (valid device page, no blob)
        bad_nodes = []
        for node in self._all_nodes():
            if node.page == HOST_PAGE and node.host_data is not None:
                continue                             # healthy demoted node
            if node.page == HOST_PAGE:
                violations.append("tier: demoted node lost its host blob")
                bad_nodes.append(node)
            elif not (self.n_slots <= node.page < self.n_pages):
                violations.append(f"trie: node holds invalid page "
                                  f"{node.page}")
                bad_nodes.append(node)
            elif node.host_data is not None:
                violations.append(f"tier: page {node.page} present in both "
                                  "tiers (resident with a host blob)")
                bad_nodes.append(node)
            elif node.page in free_set:
                violations.append(f"trie: node points at freed page "
                                  f"{node.page} (stale)")
                bad_nodes.append(node)
        implicated = {n.page for n in bad_nodes if n.page >= 0}
        if repair:
            for node in bad_nodes:
                # drop the whole subtree: children cached *behind* a bad
                # page are unreachable by prefix anyway
                if node.key in node.parent.children \
                        and node.parent.children[node.key] is node:
                    del node.parent.children[node.key]
        # 2. free-list duplicates
        seen: set[int] = set()
        for p in self.free:
            if p in seen:
                violations.append(f"free: page {p} listed more than once")
                implicated.add(p)
            seen.add(p)
        # 3. refcount == holders; free list == zero-refcount pages
        exp = self._expected_holders()
        for p in range(self.n_slots, self.n_pages):
            if p in self.quarantined:
                continue
            if self.refcount[p] != exp[p]:
                violations.append(f"refcount: page {p} is "
                                  f"{int(self.refcount[p])}, holders say "
                                  f"{int(exp[p])}")
                implicated.add(p)
            if exp[p] == 0 and p not in seen and p not in implicated:
                violations.append(f"free: page {p} has no holder but is "
                                  "not on the free list")
                implicated.add(p)
        for p in range(self.n_slots):               # scratch never circulates
            if self.refcount[p] != exp[p] or p in seen:
                violations.append(f"scratch: page {p} leaked into "
                                  "circulation")
                implicated.add(p)
        # 4. host-tier budget
        if self.host_pages is not None:
            used = self.n_host_used()
            if used > self.host_pages:
                violations.append(f"tier: {used} demoted pages exceed the "
                                  f"host pool budget {self.host_pages}")
        if repair and violations:
            for p in implicated:
                if exp[p] > 0:
                    self.refcount[p] = exp[p]       # holders are the truth
                elif p >= self.n_slots:
                    self.quarantined.add(p)         # no holder: withhold
                    self.refcount[p] = 0
            # rebuild the free list: keep surviving entries in order (free
            # order determines future page assignment), append recovered
            # strays, drop quarantined/held/duplicate entries
            rebuilt, emitted = [], set()
            for p in self.free:
                if p >= self.n_slots and exp[p] == 0 and p not in emitted \
                        and p not in self.quarantined:
                    rebuilt.append(p)
                    emitted.add(p)
            for p in range(self.n_slots, self.n_pages):
                if exp[p] == 0 and p not in emitted \
                        and p not in self.quarantined:
                    rebuilt.append(p)
                    emitted.add(p)
            self.free = deque(rebuilt)
        return violations

    # -- snapshot / restore ---------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serialisable host metadata: block tables, free list,
        allocations, refcounts, and the prefix trie (BFS order, parent
        links).  The device pools are snapshotted separately — together
        they rebuild an identical manager via :meth:`load_state`."""
        nodes: list[dict] = []
        queue = deque([(self._root, -1)])
        while queue:
            node, parent = queue.popleft()
            if node is not self._root:
                rec = {
                    "parent": parent,
                    "page": int(node.page),
                    "tokens": np.asarray(node.tokens).ravel().tolist(),
                    "dtype": str(np.asarray(node.tokens).dtype),
                    "last_used": int(node.last_used),
                }
                if node.host_data is not None:
                    rec["host"] = {name: _blob_to_json(arr)
                                   for name, arr in node.host_data.items()}
                nodes.append(rec)
                parent_idx = len(nodes) - 1
            else:
                parent_idx = -1
            for child in node.children.values():    # insertion order kept
                queue.append((child, parent_idx))
        return {
            "n_slots": self.n_slots, "page_size": self.page_size,
            "max_len": self.max_len, "n_pages": self.n_pages,
            "tables": self.tables.tolist(),
            "free": list(self.free),
            "allocated": {str(s): list(p) for s, p in self.allocated.items()},
            "refcount": self.refcount.tolist(),
            "copy_holds": {str(p): h for p, h in self._copy_holds.items()},
            "quarantined": sorted(self.quarantined),
            "clock": self._clock,
            "trie": nodes,
            "transfer": {
                "bytes_d2h": self.transfer_bytes_d2h,
                "bytes_h2d": self.transfer_bytes_h2d,
                "transfer_j": self.transfer_j,
                "n_demotions": self.n_demotions,
                "n_promotions": self.n_promotions,
            },
        }

    def load_state(self, state: dict) -> None:
        """Rebuild the manager in place from :meth:`state_dict` output."""
        for field in ("n_slots", "page_size", "max_len", "n_pages"):
            if int(state[field]) != getattr(self, field):
                raise ValueError(f"snapshot {field}={state[field]} does not "
                                 f"match pool ({getattr(self, field)})")
        self.tables = np.asarray(state["tables"], np.int32)
        self.free = deque(int(p) for p in state["free"])
        self.allocated = {int(s): [int(p) for p in pages]
                          for s, pages in state["allocated"].items()}
        self.refcount = np.asarray(state["refcount"], np.int64)
        self._copy_holds = {int(p): int(h)
                            for p, h in state["copy_holds"].items()}
        self.quarantined = {int(p) for p in state.get("quarantined", ())}
        self._clock = int(state["clock"])
        self._root = _TrieNode(None, None, -1, None)
        rebuilt: list[_TrieNode] = []
        for rec in state["trie"]:
            tokens = np.asarray(rec["tokens"], dtype=rec["dtype"])
            key = np.ascontiguousarray(tokens).tobytes()
            parent = self._root if rec["parent"] < 0 \
                else rebuilt[rec["parent"]]
            node = _TrieNode(key, tokens, int(rec["page"]), parent)
            node.last_used = int(rec["last_used"])
            if "host" in rec:
                node.host_data = {name: _blob_from_json(blob)
                                  for name, blob in rec["host"].items()}
            parent.children[key] = node
            rebuilt.append(node)
        xfer = state.get("transfer", {})
        self.transfer_bytes_d2h = int(xfer.get("bytes_d2h", 0))
        self.transfer_bytes_h2d = int(xfer.get("bytes_h2d", 0))
        self.transfer_j = float(xfer.get("transfer_j", 0.0))
        self.n_demotions = int(xfer.get("n_demotions", 0))
        self.n_promotions = int(xfer.get("n_promotions", 0))

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def occupancy(self) -> float:
        """Fraction of non-scratch pages currently allocated."""
        usable = self.n_pages - self.n_slots
        return 1.0 - len(self.free) / max(usable, 1)
