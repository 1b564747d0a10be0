"""KV and canvas storage pools for the serving engine, ported from
src/repro/serving/cache_pool.py.

Two pool flavors behind one slot-accounting surface:

* :class:`CachePool`: one fixed (max_seq_len) region per batch slot,
  sized once at engine start.  Admission never allocates, but short
  requests strand the unused tail of their slot and identical prompts
  recompute from scratch.
* :class:`PagedCachePool`: canvas and KV storage in fixed-size pages
  addressed through per-slot block tables.  Full prompt pages are keyed
  by their content in a radix tree, so requests sharing a prefix map to
  the same physical canvas pages (the first page a request will write is
  privatized at admission, before anything writes it); admission counts
  pages after prefix matching, with LRU eviction of unreferenced cached
  pages; whole requests can be preempted to host memory and restored into
  fresh pages bit for bit.

Page 0 of every store is the reserved *null page*: idle slots and the tail
of short rows map to it, so every block table is always fully populated
(core/diffusion.scatter_canvas_rows says why the duplicate entries are
safe).  The device stores and the two block tables are allocated once and
written in place (staged pages through ``index_copy_``, tables through
``copy_`` from pinned host buffers), so a tick captured as a CUDA graph
keeps reading them by address across admissions, releases, spills and
restores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import diffusion


class CachePool:
    """Fixed pool of KV cache slots, acquired/released as requests come and go.

    Slot i owns batch row i of every cache leaf, along the leaf's own
    batch axis (axis 1 of the stacked KV, (n_layers, num_slots,
    max_seq_len, ...); axis 2 of the hybrid's ``rec_state``/``rec_conv``).
    A warm tick rewrites the whole pool's cache in place (the models'
    forward), so :meth:`update` only rebinds.  ``rows`` = (r0, r1): the
    cache holds only slots r0 .. r1 - 1 (this rank's under a mesh's data
    axis), as its rows 0 .. r1 - r0 - 1; the slot accounting still spans
    every slot.
    """

    def __init__(self, model, num_slots: int, max_seq_len: int,
                 with_cache: bool = True,
                 rows: Optional[Tuple[int, int]] = None):
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.rows = (0, num_slots) if rows is None else tuple(rows)
        self.cache: Optional[Dict] = (
            model.init_cache(self.rows[1] - self.rows[0], max_seq_len)
            if with_cache else None)
        self._batch_axes = (diffusion.cache_batch_axes(model, max_seq_len)
                            if with_cache else {})
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self.acquires = 0
        self.releases = 0
        self.peak_in_use = 0

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_slots - len(self._free)

    def acquire(self) -> int:
        """Claim a free slot index; raises RuntimeError when the pool is full
        (the engine checks ``free_slots`` before admitting)."""
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        slot = self._free.pop()
        self.acquires += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return slot

    def release(self, slot: int, zero: bool = False) -> None:
        """Free ``slot``; with ``zero`` its row of every cache leaf is
        zeroed, along the leaf's batch axis (JAX's pool zeroes ``[:, slot]``
        of every leaf, the wrong axis for the hybrid's recurrent state;
        no engine path releases with ``zero``)."""
        if slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self._free.append(slot)
        self.releases += 1
        r0, r1 = self.rows
        if zero and self.cache is not None and r0 <= slot < r1:
            for name, t in self.cache.items():
                t.select(self._batch_axes[name], slot - r0).zero_()

    def update(self, new_cache) -> None:
        """Store the cache returned by a warm tick."""
        self.cache = new_cache

    def stats(self) -> dict:
        return {"num_slots": self.num_slots, "in_use": self.in_use,
                "acquires": self.acquires, "releases": self.releases,
                "peak_in_use": self.peak_in_use}


# ---------------------------------------------------------------------------
# Paged pool
# ---------------------------------------------------------------------------

class _RadixNode:
    """One page-sized prompt chunk in the prefix cache.

    Children are keyed by the raw bytes of the next chunk's token ids, so
    two prompts share a node exactly when their chunk contents are equal.
    ``refs`` counts live slots whose path runs through this node; a node
    with ``refs == 0`` keeps its physical page cached until LRU eviction
    reclaims it (leaf first: a slot referencing a deep node holds a ref on
    every ancestor, so an evictable node never has referenced children).
    """

    __slots__ = ("key", "page", "refs", "children", "parent", "last_used")

    def __init__(self, key: bytes, page: int,
                 parent: Optional["_RadixNode"]):
        self.key = key
        self.page = page
        self.refs = 0
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.parent = parent
        self.last_used = 0


@dataclasses.dataclass
class SpilledSlot:
    """Host-side image of a preempted slot: everything :meth:`restore`
    needs to rebuild bit-identical device state in fresh pages."""
    row: np.ndarray                       # (max_seq_len,) canvas
    prompt_len: int
    total_len: int
    # per paged leaf its pages (stack, n, ps, ...), per per-slot leaf the
    # slot's row, on the host
    kv_pages: Optional[Dict[str, torch.Tensor]]
    slot_leaves: Optional[Dict[str, torch.Tensor]]

    @property
    def nbytes(self) -> int:
        """Host bytes the spill holds."""
        return self.row.nbytes + sum(
            t.numel() * t.element_size()
            for leaves in (self.kv_pages, self.slot_leaves) if leaves
            for t in leaves.values())


class PagedCachePool:
    """Paged canvas/KV block pool with a radix-tree prefix cache.

    Canvas pages live in one (num_pages, page_size) int32 store; with
    ``with_cache`` every sequence-dimension cache leaf gets a matching
    (stack, num_pages, page_size, ...) store, while per-slot leaves (the
    BAOS calibration) stay dense at num_slots rows.  Each slot owns two
    block tables of ``max_seq_len / page_size`` entries: the canvas table
    may point at shared radix-cached prompt pages, the KV table is always
    private (the warm tick rewrites every KV page every tick, so KV sharing
    would be copy-on-write with an eager copy, i.e. never shared).  Unused
    table entries point at the reserved null page 0.

    Admission is footprint-aware: :meth:`can_admit` projects the new pages
    a request needs *after* prefix matching against free + evictable pages.
    The stores live on ``device`` (default: the model's, or the card).
    """

    def __init__(self, model, num_slots: int, max_seq_len: int, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 with_cache: bool = True, mask_id: int = 0,
                 prefix_cache: bool = True,
                 device: Union[str, torch.device, None] = None):
        if page_size < 2:
            raise ValueError(f"page_size must be >= 2, got {page_size}")
        if max_seq_len % page_size:
            raise ValueError(
                f"max_seq_len {max_seq_len} must be a multiple of "
                f"page_size {page_size}")
        if device is None:
            device = model.device if model is not None else "cuda"
        self.device = device_lib.resolve(device)
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.page_size = page_size
        self.pages_per_row = max_seq_len // page_size
        # slot-equivalent default: every slot can hold a full row (page 0
        # is reserved), the slot pool's capacity without the stranding
        self.num_pages = (1 + num_slots * self.pages_per_row
                          if num_pages is None else int(num_pages))
        if self.num_pages < 2:
            raise ValueError(f"num_pages must be >= 2, got {self.num_pages}")
        self.with_cache = with_cache
        self.mask_id = int(mask_id)
        self.prefix_cache = prefix_cache
        dev = self.device

        self.canvas_pages = torch.full((self.num_pages, page_size),
                                       self.mask_id, dtype=torch.int32,
                                       device=dev)
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        self._names: List[str] = []
        self._paged_flags: Optional[List[bool]] = None
        self._batch_axes: Optional[List[int]] = None
        if with_cache:
            self._names, self._paged_flags, self._batch_axes = \
                diffusion.paged_cache_layout(model, page_size, max_seq_len)
            # per-slot leaves keep their init values (BAOS scales start at
            # 1.0), so take them from a seq-minimal real cache; page stores
            # are zero pages, like init_cache's KV
            small = model.init_cache(num_slots, page_size, device=dev)
            self.cache = {}
            for name, paged in zip(self._names, self._paged_flags):
                leaf = small[name]
                self.cache[name] = (
                    torch.zeros(leaf.shape[:1] + (self.num_pages, page_size)
                                + leaf.shape[3:], dtype=leaf.dtype,
                                device=dev) if paged else leaf)

        # block tables: host mirrors in pinned memory, device copies
        # refreshed in place by flush()
        R, pin = self.pages_per_row, dev.type == "cuda"
        self._canvas_host = torch.zeros((num_slots, R), dtype=torch.int64,
                                        pin_memory=pin)
        self._kv_host = torch.zeros((num_slots, R), dtype=torch.int64,
                                    pin_memory=pin)
        self._canvas_np = self._canvas_host.numpy()
        self._kv_np = self._kv_host.numpy()
        self.canvas_table = self._canvas_host.to(dev, copy=True)
        self.kv_table = self._kv_host.to(dev, copy=True)
        self._tables_dirty = False
        self._staged: Dict[int, np.ndarray] = {}       # canvas page writes

        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._free_canvas: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._free_kv: List[int] = (list(range(self.num_pages - 1, 0, -1))
                                    if with_cache else [])
        # per-slot page ownership: canvas -> (page, node-or-None) pairs,
        # kv -> plain page lists
        self._slot_canvas: Dict[int, List[Tuple[int, Optional[_RadixNode]]]] \
            = {}
        self._slot_kv: Dict[int, List[int]] = {}
        self._slot_len: Dict[int, int] = {}

        self._root = _RadixNode(b"", 0, None)
        self._nodes: List[_RadixNode] = []
        self._clock = 0

        self.acquires = 0
        self.releases = 0
        self.peak_in_use = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.evictions = 0
        self.preemptions = 0
        self.restores = 0
        self.peak_pages_in_use = 0
        # optional hook for pool-internal page edges (prefix_hit, evict,
        # spill, restore), called as event_cb(kind, **fields); uid-less,
        # since the pool tracks slots and pages, not requests
        self.event_cb: Optional[Callable[..., None]] = None

    # -- slot accounting (CachePool-compatible surface) ---------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_slots - len(self._free)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        slot = self._free.pop()
        self.acquires += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return slot

    # -- page accounting ----------------------------------------------------

    def pages_needed(self, total_len: int) -> int:
        """Pages per store a ``total_len`` request occupies (worst case,
        no prefix sharing)."""
        return -(-int(total_len) // self.page_size)

    @property
    def free_canvas_pages(self) -> int:
        return len(self._free_canvas)

    @property
    def free_kv_pages(self) -> int:
        return len(self._free_kv)

    @property
    def cached_pages(self) -> int:
        """Radix-cached canvas pages with no live referent (evictable)."""
        return sum(1 for n in self._nodes if n.refs == 0)

    @property
    def pages_in_use(self) -> int:
        canvas = self.num_pages - 1 - len(self._free_canvas)
        kv = (self.num_pages - 1 - len(self._free_kv)) if self.with_cache \
            else 0
        return canvas + kv

    def _match_prefix(self, row: np.ndarray, prompt_len: int,
                      mutate: bool) -> Tuple[int, List[_RadixNode]]:
        """Walk the radix tree over full prompt pages.  Returns the number
        of matched pages and the path; with ``mutate`` bumps their LRU
        stamps."""
        if not self.prefix_cache:
            return 0, []
        ps = self.page_size
        node, path = self._root, []
        for p in range(prompt_len // ps):
            child = node.children.get(row[p * ps:(p + 1) * ps].tobytes())
            if child is None:
                break
            path.append(child)
            node = child
        if mutate:
            self._clock += 1
            for n in path:
                n.last_used = self._clock
        return len(path), path

    def projected_pages(self, prompt: np.ndarray,
                        total_len: int) -> Tuple[int, int]:
        """(new canvas pages, new KV pages) admitting this request would
        allocate, after prefix matching.  Read-only."""
        row = np.asarray(prompt, np.int32).reshape(-1)
        n = self.pages_needed(total_len)
        hits, _ = self._match_prefix(row, row.shape[0], mutate=False)
        return n - hits, (n if self.with_cache else 0)

    def can_admit(self, prompt: np.ndarray, total_len: int) -> bool:
        """Footprint-aware admission check: projected pages against free +
        evictable pages in both stores (plus a free slot)."""
        if not self._free:
            return False
        c_new, k_new = self.projected_pages(prompt, total_len)
        if c_new > len(self._free_canvas) + self.cached_pages:
            return False
        return (not self.with_cache) or k_new <= len(self._free_kv)

    # -- allocation ---------------------------------------------------------

    def _evict_one(self) -> bool:
        victim = None
        for n in self._nodes:
            if n.refs == 0 and not n.children:
                if victim is None or n.last_used < victim.last_used:
                    victim = n
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self._nodes.remove(victim)
        self._free_canvas.append(victim.page)
        self.evictions += 1
        if self.event_cb is not None:
            self.event_cb("evict", page=victim.page)
        return True

    def _alloc_canvas(self) -> int:
        if not self._free_canvas and not self._evict_one():
            raise RuntimeError("paged pool: out of canvas pages")
        return self._free_canvas.pop()

    def bind_row(self, slot: int, row: np.ndarray, prompt_len: int,
                 total_len: int) -> None:
        """Map ``slot`` onto physical pages for a freshly admitted request.

        Full prompt pages go through the radix tree (hit: the shared page,
        no upload; miss: a new page, staged for upload and inserted so
        later requests share it).  The first page holding generation
        positions is the copy-on-write point: it is privatized here,
        seeded with the row's own content, before any tick writes to it.
        Unused tail entries stay on the null page.
        """
        row = np.ascontiguousarray(np.asarray(row, np.int32))
        ps = self.page_size
        n = self.pages_needed(total_len)
        n_full_prompt = min(prompt_len // ps, n)
        hits, path = self._match_prefix(row, n_full_prompt * ps, mutate=True)
        self.prefix_hits += hits
        if hits and self.event_cb is not None:
            self.event_cb("prefix_hit", slot=slot, pages=hits)
        # ref the matched path before allocating the rest: _alloc_canvas
        # may evict, and an unreferenced node on our own path would be
        # fair game for the evictor
        for nd in path:
            nd.refs += 1
        owned: List[Tuple[int, Optional[_RadixNode]]] = \
            [(nd.page, nd) for nd in path]
        node = path[-1] if path else self._root
        self._clock += 1
        for p in range(hits, n):
            page = self._alloc_canvas()
            chunk = row[p * ps:(p + 1) * ps]
            self._staged[page] = chunk.copy()
            nd = None
            if self.prefix_cache and p < n_full_prompt:
                self.prefix_misses += 1
                nd = _RadixNode(chunk.tobytes(), page, node)
                nd.refs = 1
                nd.last_used = self._clock
                node.children[nd.key] = nd
                self._nodes.append(nd)
                node = nd
            owned.append((page, nd))
        table = self._canvas_np[slot]
        table[:] = 0
        table[:n] = [p for p, _ in owned]
        kv_pages: List[int] = []
        if self.with_cache:
            if len(self._free_kv) < n:
                raise RuntimeError("paged pool: out of KV pages")
            kv_pages = [self._free_kv.pop() for _ in range(n)]
            kt = self._kv_np[slot]
            kt[:] = 0
            kt[:n] = kv_pages
        self._slot_canvas[slot] = owned
        self._slot_kv[slot] = kv_pages
        self._slot_len[slot] = total_len
        self._tables_dirty = True
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    def _free_slot_pages(self, slot: int) -> None:
        self._clock += 1
        for page, nd in self._slot_canvas.pop(slot, ()):
            if nd is None:
                self._free_canvas.append(page)
            else:
                nd.refs -= 1
                nd.last_used = self._clock
        self._free_kv.extend(self._slot_kv.pop(slot, ()))
        self._slot_len.pop(slot, None)
        self._canvas_np[slot] = 0
        self._kv_np[slot] = 0
        self._tables_dirty = True

    def release(self, slot: int, zero: bool = False) -> None:
        """Free ``slot`` and its pages (``zero`` is accepted for the slot
        pool's surface: freed pages are rewritten before they are read)."""
        if slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self._free_slot_pages(slot)
        self._free.append(slot)
        self.releases += 1

    def flush(self) -> None:
        """Upload the staged canvas pages (one ``index_copy_``) and, when
        dirty, both block tables (a ``copy_`` each from pinned memory), in
        place: N admissions per tick cost one scatter and one table
        refresh, not N.  The host mirrors are next written after the
        tick's device sync, so the asynchronous table copies have read
        them by then."""
        if self._staged:
            idx = torch.tensor(list(self._staged), dtype=torch.int64)
            vals = torch.from_numpy(np.stack(list(self._staged.values())))
            self.canvas_pages.index_copy_(0, idx.to(self.device),
                                          vals.to(self.device))
            self._staged = {}
        if self._tables_dirty:
            self.canvas_table.copy_(self._canvas_host, non_blocking=True)
            self.kv_table.copy_(self._kv_host, non_blocking=True)
            self._tables_dirty = False

    # -- preemption ---------------------------------------------------------

    def _row_pages(self, table: np.ndarray, slot: int, n: int
                   ) -> torch.Tensor:
        return torch.from_numpy(table[slot, :n].copy()).to(self.device)

    def spill(self, slot: int) -> SpilledSlot:
        """Copy a slot's pages to the host and free them (the scheduler's
        preemption path).  The canvas row, every paged cache leaf's pages
        and the per-slot leaves' rows are captured, so :meth:`restore`
        rebuilds bit-identical device state."""
        self.flush()
        total_len = self._slot_len[slot]
        n = self.pages_needed(total_len)
        row = self.canvas_pages.index_select(
            0, self._row_pages(self._canvas_np, slot, n)).reshape(-1)
        row = np.concatenate(
            [row.cpu().numpy(),
             np.full((self.max_seq_len - n * self.page_size,), self.mask_id,
                     np.int32)])
        prompt_len = total_len            # recomputed by caller if needed
        kv_pages = slot_leaves = None
        if self.with_cache:
            ktable = self._row_pages(self._kv_np, slot, n)
            kv_pages, slot_leaves = {}, {}
            for name, paged, ax in zip(self._names, self._paged_flags,
                                       self._batch_axes):
                leaf = self.cache[name]
                if paged:
                    kv_pages[name] = leaf.index_select(1, ktable).to(
                        "cpu", copy=True)
                else:
                    slot_leaves[name] = leaf.select(ax, slot).to(
                        "cpu", copy=True)
        self._free_slot_pages(slot)
        self._free.append(slot)
        self.preemptions += 1
        if self.event_cb is not None:
            self.event_cb("spill", slot=slot, pages=n, total_len=total_len)
        return SpilledSlot(row=row, prompt_len=prompt_len,
                           total_len=total_len, kv_pages=kv_pages,
                           slot_leaves=slot_leaves)

    def can_restore(self, sp: SpilledSlot) -> bool:
        return self.can_admit(sp.row[:sp.prompt_len], sp.total_len)

    def restore(self, slot: int, sp: SpilledSlot) -> None:
        """Upload a spilled slot into fresh pages (prefix pages may re-hit
        the radix cache, so a restore can be cheaper than the original
        admission).  The KV pages and per-slot rows are written into the
        stores in place; the canvas pages are staged for the next flush."""
        self.bind_row(slot, sp.row, sp.prompt_len, sp.total_len)
        if self.with_cache:
            ktable = self._row_pages(self._kv_np, slot,
                                     self.pages_needed(sp.total_len))
            for name, paged, ax in zip(self._names, self._paged_flags,
                                       self._batch_axes):
                leaf = self.cache[name]
                if paged:
                    leaf.index_copy_(1, ktable,
                                     sp.kv_pages[name].to(self.device))
                else:
                    leaf.select(ax, slot).copy_(sp.slot_leaves[name])
        self.restores += 1
        if self.event_cb is not None:
            self.event_cb("restore", slot=slot,
                          pages=self.pages_needed(sp.total_len))

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        lookups = self.prefix_hits + self.prefix_misses
        return {
            "num_slots": self.num_slots, "in_use": self.in_use,
            "acquires": self.acquires, "releases": self.releases,
            "peak_in_use": self.peak_in_use,
            "page_size": self.page_size, "num_pages": self.num_pages,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "free_canvas_pages": len(self._free_canvas),
            "free_kv_pages": len(self._free_kv),
            "cached_pages": self.cached_pages,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": self.prefix_hits / lookups if lookups else 0.0,
            "evictions": self.evictions,
            "preemptions": self.preemptions, "restores": self.restores,
        }
