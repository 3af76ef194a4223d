"""ModelRunner: executes one model (target or drafter) over a slot-based,
device-resident batched cache (port of `repro.serving.runner`, resident
path).

Slot model (continuous batching): the runner preallocates ONE cache whose
batch axis is a pool of request slots. Requests are admitted into free
slots at prefill and evicted on completion; every batched step passes its
active slot indices down to attention, which writes only the new tokens'
rows in place and reads the active rows through the indices. Active-slot
counts are padded to buckets like the reference (so both run the same
shapes); padded rows map to a scratch slot (index 0) that no request
owns, so their writes are never read.

Speculative rollback is snapshot-based: drafting gathers a compact copy
of the slots (`speculative_caches`) and decodes on it; discarding the
snapshot IS the rollback.

Paged mode (`ModelRunner(..., paged=True)`): the attention KV lives in a
pool of pages instead of reserved per-slot rows. `PagedSlotCacheManager`
keeps a host-side block table per request and hands every step a
`page_view`; admission, eviction and rollback become block-table
operations, and memory scales with the tokens held.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import model as M
from repro_torch.models import quantize
from repro_torch.models.attention import RING_MARGIN, cache_capacity

# Shape-bucket constants, as in the reference: an arbitrary-length prompt
# streams through `slot_extend` as full PREFILL_CHUNK-sized writes plus
# one final chunk padded up to the next bucket with the pad masked out;
# active-batch sizes are snapped up to SLOT_BUCKETS.
PREFILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
PREFILL_CHUNK = 512
SLOT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Speculative snapshots gathered from a paged pool reserve this much
# column slack past each request's length so draft-ahead writes never
# wrap a full-attention snapshot (the largest segment one step writes).
SNAP_SLACK = 128


def prefill_bucket(n: int) -> int:
    """Smallest prefill chunk shape >= n (n <= PREFILL_CHUNK)."""
    for b in PREFILL_BUCKETS:
        if b >= n:
            return b
    return PREFILL_CHUNK


def prefill_chunk_len(cfg: ModelConfig) -> int:
    """Max prefill chunk width: windowed configs chunk at the ring margin
    so one write never wraps onto keys still inside a query's window."""
    return min(PREFILL_CHUNK, RING_MARGIN) if M.effective_window(cfg) \
        else PREFILL_CHUNK


def slot_bucket(n: int) -> int:
    """Smallest bucket >= n; past the table, the next power of two."""
    for b in SLOT_BUCKETS:
        if b >= n:
            return b
    return 1 << (n - 1).bit_length()


class SlotCacheManager:
    """Owns the slotted cache: slot admission/eviction/reset and capacity
    growth (doubling).

    Slot 0 is scratch (padding target); real slots are 1..n_slots.
    """

    SCRATCH = 0
    IDX_CACHE_MAX = 512

    def __init__(self, cfg: ModelConfig, max_len: int, n_slots: int = 8,
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.max_len = max_len
        self.dtype = dtype
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self.cache = M.init_cache(cfg, n_slots + 1, max_len, dtype=dtype,
                                  device=self.device)
        self._free = list(range(n_slots, 0, -1))      # pop() -> slot 1 first
        self.slot_of: Dict[int, int] = {}
        self._idx_cache: Dict[tuple, torch.Tensor] = {}

    # -------------------------------------------------------------- admission
    def admit(self, rid: int) -> int:
        """Assign (or return) `rid`'s slot, growing the pool if full; the
        slot is emptied of its previous tenant's rows."""
        if rid in self.slot_of:
            return self.slot_of[rid]
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.slot_of[rid] = slot
        M.reset_slots(self.cache, torch.tensor([slot], device=self.device))
        return slot

    def release(self, rid: int):
        """Free `rid`'s slot and drop stale memoized batch indices."""
        slot = self.slot_of.pop(rid, None)
        if slot is not None:
            self._free.append(slot)
            for key in [k for k in self._idx_cache if rid in k]:
                del self._idx_cache[key]

    def _grow(self):
        extra = M.init_cache(self.cfg, self.n_slots, self.max_len,
                             dtype=self.dtype, device=self.device)
        self.cache = M.concat_slots(self.cache, extra)
        self._free.extend(range(2 * self.n_slots, self.n_slots, -1))
        self.n_slots *= 2

    # -------------------------------------------------------------- indexing
    def padded_idx(self, rids: Sequence[int]) -> torch.Tensor:
        """Bucketed (B_bucket,) int32 slot indices on the device; padding
        rows -> scratch. Memoized per rids tuple (bounded FIFO)."""
        key = tuple(rids)
        idx = self._idx_cache.get(key)
        if idx is None:
            while len(self._idx_cache) >= self.IDX_CACHE_MAX:
                self._idx_cache.pop(next(iter(self._idx_cache)))
            lst = [self.slot_of[r] for r in rids]
            lst += [self.SCRATCH] * (slot_bucket(len(lst)) - len(lst))
            idx = self._idx_cache[key] = torch.tensor(
                lst, dtype=torch.int32, device=self.device)
        return idx

    def length(self, rid: int) -> int:
        """Committed tokens in `rid`'s slot (device-authoritative)."""
        return int(self.cache["lengths"][self.slot_of[rid]])

    # ------------------------------------------------------------ paged hooks
    # The resident pool reserves full capacity per slot, so the paged
    # protocol is a no-op here; ModelRunner calls these unconditionally
    # and passes the returned page_view (None) through to the steps.
    def prepare(self, rids: Sequence[int],
                write: int) -> Optional[torch.Tensor]:
        """Map pages for the next `write` columns of each rid and return
        the batch page_view (None on the resident pool)."""
        return None

    def advance(self, rid: int, n: int):
        """Record `n` committed tokens (paged bookkeeping; no-op here)."""

    def snapshot_view(self, rids: Sequence[int]) -> Optional[torch.Tensor]:
        """page_view for a speculative snapshot (None on the resident
        pool)."""
        return None


class PagedSlotCacheManager(SlotCacheManager):
    """Slot manager over a paged KV pool.

    The attention KV of every attention layer lives in one pool of
    `page_size`-token pages; each request owns an ordered host-side block
    table mapping its logical pages to physical ones. SSM state and
    `lengths` stay slot-indexed (a model without attention has no pools;
    its block tables are kept all the same, as the reference keeps them).

    Protocol: every write site calls `prepare(rids, write=W)` first — it
    maps any page the next W columns touch and returns the bucketed
    (rows, n_view) page_view — and `advance(rid, n_real)` after the write
    commits. Eviction (`release`) wipes the pages' slot_pos in one batched
    reset and returns them to the free list, so recycled pages are
    invisible until rewritten. Rollback needs nothing: speculative
    snapshots are gathered copies (`gather_paged_slots`).

    Physical pages 0 and 1 are reserved: 0 is SCRATCH (write target of
    padded batch rows, never read by a request) and 1 is NULL (read
    filler for unmapped view entries, never written, slot_pos -1).

    Windowed layers keep their ring: the block table is a fixed ring of
    C / page_size entries (C = window + RING_MARGIN, page_size halved
    until it divides C) mapped on first touch, and the view is always the
    whole ring, so write columns pos % C land as on the resident ring.
    """

    SCRATCH_PAGE = 0
    NULL_PAGE = 1
    _RESERVED = 2
    VIEW_CACHE_MAX = 512

    def __init__(self, cfg: ModelConfig, max_len: int, n_slots: int = 8,
                 dtype=torch.float32, device=None, page_size: int = 64,
                 pool_pages: int = 0):
        self.cfg = cfg
        self.max_len = max_len
        self.dtype = dtype
        self.n_slots = n_slots
        self.device = resolve_device(device)
        win = M.effective_window(cfg)
        ps = max(1, page_size)
        if win:
            cap = cache_capacity(cfg, max_len, win)
            while cap % ps:        # ring capacity must be whole pages
                ps //= 2
            self.ring_pages = cap // ps
        else:
            self.ring_pages = 0
        self.page_size = ps
        n_pages = pool_pages or (self._RESERVED + 4 * n_slots)
        self.n_pages = max(n_pages, self._RESERVED + 1)
        self.cache = M.init_paged_cache(cfg, n_slots + 1, dtype=dtype,
                                        page_size=ps, n_pages=self.n_pages,
                                        device=self.device)
        self._free = list(range(n_slots, 0, -1))      # pop() -> slot 1 first
        self._free_pages = list(range(self.n_pages - 1,
                                      self._RESERVED - 1, -1))
        self.slot_of: Dict[int, int] = {}
        self._idx_cache: Dict[tuple, torch.Tensor] = {}
        self._view_cache: Dict[bytes, torch.Tensor] = {}
        self.tables: Dict[int, List[int]] = {}
        self.host_len: Dict[int, int] = {}
        #: pool doublings so far
        self.n_page_growths = 0

    # -------------------------------------------------------------- admission
    def admit(self, rid: int) -> int:
        """Assign a slot and an empty block table; resets only the
        slot-indexed leaves (pages are mapped lazily by `prepare`)."""
        if rid in self.slot_of:
            return self.slot_of[rid]
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.slot_of[rid] = slot
        self.tables[rid] = [-1] * self.ring_pages if self.ring_pages else []
        self.host_len[rid] = 0
        M.reset_slot_state(self.cfg, self.cache,
                           torch.tensor([slot], device=self.device))
        return slot

    def release(self, rid: int):
        """Free the slot, wipe the mapped pages' slot_pos in one batched
        reset, and return them to the free list."""
        pids = [p for p in self.tables.pop(rid, []) if p >= 0]
        self.host_len.pop(rid, None)
        super().release(rid)
        if pids:
            M.reset_pages(self.cfg, self.cache,
                          torch.tensor(pids, device=self.device))
            self._free_pages.extend(reversed(pids))

    def _grow(self):
        extra = M.init_slot_leaves(self.cfg, self.n_slots, device=self.device)
        self.cache = M.concat_slots_paged(self.cfg, self.cache, extra)
        self._free.extend(range(2 * self.n_slots, self.n_slots, -1))
        self.n_slots *= 2

    def _grow_pages(self):
        extra = self.n_pages                      # double the pool
        M.grow_pages(self.cfg, self.cache, extra)
        self._free_pages = (list(range(self.n_pages + extra - 1,
                                       self.n_pages - 1, -1))
                            + self._free_pages)
        self.n_pages += extra
        self.n_page_growths += 1

    def _alloc_page(self) -> int:
        if not self._free_pages:
            self._grow_pages()
        return self._free_pages.pop()

    # -------------------------------------------------------------- paging
    def ensure(self, rid: int, upto: int):
        """Map every page that columns [host_len, upto) touch: full
        attention grows the table, windowed layers map ring entries on
        first touch."""
        tbl = self.tables[rid]
        hl = self.host_len[rid]
        ps = self.page_size
        if upto <= hl:
            return
        if self.ring_pages:
            for lp in range(hl // ps, (upto - 1) // ps + 1):
                r = lp % self.ring_pages
                if tbl[r] < 0:
                    tbl[r] = self._alloc_page()
        else:
            need = (upto + ps - 1) // ps
            while len(tbl) < need:
                tbl.append(self._alloc_page())

    def view(self, rids: Sequence[int], extra: int = 0) -> torch.Tensor:
        """Bucketed (rows, n_view) int32 block-table view of a batch, on
        the device: n_view covers each rid's held tokens plus `extra`
        columns, snapped to a power of two (windowed: always the whole
        ring). Unmapped entries -> NULL page; padded batch rows ->
        SCRATCH. Built on the host and memoized per distinct content
        (bounded FIFO), so a step costs at most one copy."""
        rows = slot_bucket(max(len(rids), 1))
        ps = self.page_size
        if self.ring_pages:
            nv = self.ring_pages
        else:
            need = 1
            for r in rids:
                need = max(need, -(-(self.host_len[r] + extra) // ps))
            nv = 1 << (need - 1).bit_length()
        out = np.full((rows, nv), self.NULL_PAGE, np.int32)
        for j, r in enumerate(rids):
            for i, p in enumerate(self.tables[r][:nv]):
                if p >= 0:
                    out[j, i] = p
        out[len(rids):, :] = self.SCRATCH_PAGE
        key = nv.to_bytes(4, "little") + out.tobytes()
        t = self._view_cache.get(key)
        if t is None:
            while len(self._view_cache) >= self.VIEW_CACHE_MAX:
                self._view_cache.pop(next(iter(self._view_cache)))
            t = self._view_cache[key] = torch.from_numpy(out).to(self.device)
        return t

    def prepare(self, rids: Sequence[int], write: int) -> torch.Tensor:
        """Map pages for the next `write` columns of each rid and return
        the page_view covering held + write columns."""
        if write:
            for r in rids:
                self.ensure(r, self.host_len[r] + write)
        return self.view(rids, extra=write)

    def advance(self, rid: int, n: int):
        """Record `n` committed tokens (host paging mirror)."""
        self.host_len[rid] += n

    def snapshot_view(self, rids: Sequence[int]) -> torch.Tensor:
        """View for a snapshot gather with SNAP_SLACK columns of slack so
        draft-ahead writes on the (copied) snapshot never wrap."""
        return self.view(rids, extra=SNAP_SLACK)

    # -------------------------------------------------------------- accounting
    def pages_held(self) -> int:
        """Physical pages currently mapped by live requests."""
        return sum(sum(1 for p in t if p >= 0) for t in self.tables.values())

    def fragmentation(self) -> float:
        """Fraction of held page capacity that is not live tokens: the
        internal fragmentation of the tail pages (0.0 = perfectly full)."""
        held = self.pages_held() * self.page_size
        if not held:
            return 0.0
        live = sum(min(self.host_len[r], self.ring_pages * self.page_size
                       if self.ring_pages else self.host_len[r])
                   for r in self.tables)
        return 1.0 - live / held


class ModelRunner:
    """Executes one model over its slot cache with bucketed steps.

    paged=True swaps the reserved-capacity `SlotCacheManager` for the
    `PagedSlotCacheManager` (page-pool KV, block tables); every step then
    threads the manager's `page_view` into the model's reads and writes.
    The two modes commit identical tokens.

    Runs on CUDA unless `device="cpu"`; `params` must already live on
    that device (see `models.model.init_params`, `models.convert`)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 cache_dtype=torch.float32, n_slots: int = 8,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        emb = params["embed"]
        emb_dev = (emb["w8"] if quantize.is_quantized(emb) else emb).device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, the runner on "
                             f"{self.device}")
        self.cache_dtype = torch_dtype(cache_dtype)
        self.paged = paged
        if paged:
            self.slots: SlotCacheManager = PagedSlotCacheManager(
                cfg, max_len, n_slots, self.cache_dtype, self.device,
                page_size=page_size, pool_pages=pool_pages)
        else:
            self.slots = SlotCacheManager(cfg, max_len, n_slots,
                                          self.cache_dtype, self.device)
        # routing prior embeddings: a host f32 copy of the real vocab rows,
        # dequantized for int8 tables
        self.embed_np = quantize.dequantize_weight(emb)[: cfg.vocab
                                                        ].cpu().numpy()
        # masked slot_extend writes issued by the prefill paths
        self.n_prefill_writes = 0

    def _t(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _host(self, t) -> np.ndarray:
        return t.float().cpu().numpy()

    # ----------------------------------------------------------- lifecycle
    def prefill_request(self, rid: int, tokens: np.ndarray):
        """Admit a slot and prefill the request's context; returns
        (last-position logits (V,), mean next-token logprob of the context
        under this model) — the latter is the routing prior."""
        self.slots.admit(rid)
        toks = np.asarray(tokens, np.int32)
        if len(toks) == 0:
            # one-behind drafter cache of a single-token prompt: the slot
            # holds the empty context; the first decode() fills it
            return None, 0.0
        sidx = self.slots.padded_idx([rid])
        rows = int(sidx.shape[0])
        chunk_len = prefill_chunk_len(self.cfg)
        logits = None
        ll_sum, ll_n = 0.0, 0
        i = 0
        n_real = 0
        while i < len(toks):
            n_real = min(chunk_len, len(toks) - i)
            width = min(prefill_bucket(n_real), chunk_len)
            if i + width > self.max_len:
                # a padded tail would spill past the cache capacity
                width = n_real
            seg = np.zeros((rows, width), np.int32)
            seg[0, :n_real] = toks[i: i + n_real]
            mask = np.zeros((rows, width), bool)
            mask[0, :n_real] = True            # batch-pad rows stay masked
            pv = self.slots.prepare([rid], write=width)
            logits, _, _ = M.slot_extend(
                self.params, self.cfg, self._t(seg), self.slots.cache, sidx,
                token_mask=self._t(mask, torch.bool), page_view=pv)
            self.n_prefill_writes += 1
            self.slots.advance(rid, n_real)
            nxt = toks[i + 1: i + n_real]
            if len(nxt):
                lp = torch.log_softmax(
                    logits[0, : len(nxt), : self.cfg.vocab].float(), -1)
                ll_sum += float(lp.gather(
                    -1, self._t(nxt, torch.long)[:, None]).sum())
                ll_n += len(nxt)
            i += n_real
        mean_ll = ll_sum / max(ll_n, 1)
        return self._host(logits[0, n_real - 1, : self.cfg.vocab]), mean_ll

    def prefill_requests(self, reqs: Dict[int, Sequence[int]]
                         ) -> Dict[int, tuple]:
        """Burst admission: prefill several cold requests with ONE masked
        `slot_extend` write (each request a row). Long prompts, empty
        contexts and singleton bursts fall back to `prefill_request`."""
        out: Dict[int, tuple] = {}
        chunk_len = min(prefill_chunk_len(self.cfg), self.max_len)
        batch: Dict[int, np.ndarray] = {}
        for rid, tokens in reqs.items():
            toks = np.asarray(tokens, np.int32)
            if 0 < len(toks) <= chunk_len:
                batch[rid] = toks
            else:
                out[rid] = self.prefill_request(rid, toks)
        if len(batch) == 1:
            rid, toks = next(iter(batch.items()))
            out[rid] = self.prefill_request(rid, toks)
            return out
        if not batch:
            return out
        for rid in batch:
            self.slots.admit(rid)
        rids = list(batch)
        sidx = self.slots.padded_idx(rids)
        rows = int(sidx.shape[0])
        maxn = max(len(t) for t in batch.values())
        width = min(prefill_bucket(maxn), chunk_len)
        seg = np.zeros((rows, width), np.int32)
        mask = np.zeros((rows, width), bool)
        for j, rid in enumerate(rids):
            t = batch[rid]
            seg[j, : len(t)] = t
            mask[j, : len(t)] = True
        pv = self.slots.prepare(rids, write=width)
        logits, _, _ = M.slot_extend(
            self.params, self.cfg, self._t(seg), self.slots.cache, sidx,
            token_mask=self._t(mask, torch.bool), page_view=pv)
        self.n_prefill_writes += 1
        for rid in rids:
            self.slots.advance(rid, len(batch[rid]))
        lp = self._host(torch.log_softmax(
            logits[:, :, : self.cfg.vocab].float(), -1))
        lg = self._host(logits[:, :, : self.cfg.vocab])
        for j, rid in enumerate(rids):
            t = batch[rid]
            n = len(t)
            nxt = t[1:]
            ll = (float(np.take_along_axis(
                lp[j, : n - 1], nxt[:, None], -1).sum()) / (n - 1)
                if n > 1 else 0.0)
            out[rid] = (lg[j, n - 1], ll)
        return out

    def drop(self, rid: int):
        """Evict `rid`: its slot (and pages, when paged) return to the
        pool."""
        self.slots.release(rid)

    # ----------------------------------------------------------- batched ops
    def speculative_caches(self, rids: Sequence[int]):
        """Compact device-side copy of the requests' slots (bucketed
        batch). Decoding on it never touches the slotted cache —
        discarding it is the speculative rollback. On a paged pool it
        copies only the mapped pages (plus SNAP_SLACK columns of write
        headroom) into a plain batch cache."""
        idx = self.slots.padded_idx(rids)
        pv = self.slots.snapshot_view(rids)
        if pv is None:
            return M.gather_slots(self.slots.cache, idx)
        return M.gather_paged_slots(self.cfg, self.slots.cache, idx, pv)

    def extend_snapshot(self, caches: dict, tokens: np.ndarray):
        """Teacher-force `tokens` (B, T) into a speculative snapshot;
        padded batch rows receive garbage that is never read. Returns
        (last logits (B, V), caches)."""
        B = tokens.shape[0]
        rows = int(caches["lengths"].shape[0])
        lg, caches, _ = M.extend(
            self.params, self.cfg,
            self._t(self._pad_rows(np.asarray(tokens, np.int32), rows)),
            caches)
        return self._host(lg[:B, -1, : self.cfg.vocab]), caches

    def _pad_rows(self, a: np.ndarray, rows: int) -> np.ndarray:
        if a.shape[0] == rows:
            return a
        pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad], axis=0)

    def decode(self, rids: Sequence[int], tokens: np.ndarray,
               caches: Optional[dict] = None):
        """One decode step. tokens: (B,). Returns logits (B, V) and, when
        `caches` (a speculative snapshot) is passed, the snapshot (updated
        in place); otherwise the slotted cache is updated and None
        returned."""
        B = len(rids)
        toks = np.asarray(tokens, np.int32)
        if caches is not None:
            rows = int(caches["lengths"].shape[0])
            lg, new_cache, _ = M.decode_step(
                self.params, self.cfg,
                self._t(self._pad_rows(toks, rows))[:, None], caches)
        else:
            sidx = self.slots.padded_idx(rids)
            pv = self.slots.prepare(rids, write=1)
            lg, _, _ = M.slot_decode_step(
                self.params, self.cfg,
                self._t(self._pad_rows(toks, int(sidx.shape[0])))[:, None],
                self.slots.cache, sidx, page_view=pv)
            for r in rids:
                self.slots.advance(r, 1)
            new_cache = None
        return self._host(lg[:B, 0, : self.cfg.vocab]), new_cache

    def verify_device(self, rids: Sequence[int], tokens: np.ndarray,
                      rel_pos: np.ndarray, seg_mask: np.ndarray
                      ) -> torch.Tensor:
        """Tree/chain verification forward (no cache commit), result left
        on the device: (rows, Gmax, padded vocab) logits. The async
        backend's server dispatches this and the engine copies the real
        rows to the host only when its acceptance walk reads them."""
        B, G = tokens.shape
        sidx = self.slots.padded_idx(rids)
        rows = int(sidx.shape[0])
        mask = np.asarray(seg_mask, bool)
        if rows != B:
            # padded (scratch) rows verify a lower-triangular dummy segment
            mask = np.concatenate(
                [mask, np.broadcast_to(np.tril(np.ones((G, G), bool)),
                                       (rows - B, G, G))], axis=0)
        pv = self.slots.prepare(rids, write=0)
        return M.slot_verify_chunk(
            self.params, self.cfg,
            self._t(self._pad_rows(np.asarray(tokens, np.int32), rows)),
            self.slots.cache, sidx,
            self._t(self._pad_rows(np.asarray(rel_pos, np.int32), rows)),
            self._t(mask, torch.bool), page_view=pv)

    def verify(self, rids: Sequence[int], tokens: np.ndarray,
               rel_pos: np.ndarray, seg_mask: np.ndarray) -> np.ndarray:
        """Tree/chain verification (no cache commit).

        tokens: (B, Gmax); rel_pos: (B, Gmax) node depths; seg_mask
        (B, Gmax, Gmax) ancestor mask. Returns logits (B, Gmax, V)."""
        B = tokens.shape[0]
        lg = self.verify_device(rids, tokens, rel_pos, seg_mask)
        return self._host(lg[:B, :, : self.cfg.vocab])

    def extend_committed(self, rid_tokens: Dict[int, List[int]]
                         ) -> Dict[int, np.ndarray]:
        """Commit accepted tokens per request into the slotted cache;
        returns each request's post-commit tail logits (V,). Groups by
        token count so shapes stay exact."""
        out: Dict[int, np.ndarray] = {}
        by_len: Dict[int, List[int]] = {}
        for rid, toks in rid_tokens.items():
            by_len.setdefault(len(toks), []).append(rid)
        for n, rids in by_len.items():
            if n == 0:
                continue
            sidx = self.slots.padded_idx(rids)
            toks = np.asarray([rid_tokens[r] for r in rids], np.int32)
            pv = self.slots.prepare(rids, write=n)
            lg, _, _ = M.slot_extend(
                self.params, self.cfg,
                self._t(self._pad_rows(toks, int(sidx.shape[0]))),
                self.slots.cache, sidx, page_view=pv)
            tails = self._host(lg[: len(rids), -1, : self.cfg.vocab])
            for i, r in enumerate(rids):
                out[r] = tails[i]
                self.slots.advance(r, n)
        return out

    def length(self, rid: int) -> int:
        """Committed tokens for `rid`."""
        return self.slots.length(rid)
