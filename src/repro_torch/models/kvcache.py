"""KV-cache structures: dense per-slot rows and the paged block pool.

The same two layouts as the reference (``repro/models/kvcache.py``), with
the same masking contract: every slot (dense) or pool entry (paged) carries
the absolute position written into it in ``pos_map`` (−1 = empty), which
uniformly handles append-at-pos decode, ring-buffer caches and speculative
rollback (rejected window entries keep a position beyond the committed one
and stay masked until overwritten).

- :class:`AttnCache` — the dense layout, ``(L, B, S, Hkv, hd)`` rows.
- :class:`PagedAttnCache` — the paged layout, a shared ``(L, NB, bs, Hkv,
  hd)`` block pool plus a per-slot ``(B, n_log)`` block table (−1 =
  unmapped), optional int8 K/V with f32 per-entry scales.
- :class:`SSMCache` — the Mamba2 recurrent state: conv tails ``(L, B,
  K−1, conv_dim)`` in the model dtype and SSD states ``(L, B, nh, hd, N)``
  in f32; :class:`HybridCacheT` pairs it with the hybrid's shared-attention
  :class:`AttnCache` (one layer per shared-block call).

Attention caches are updated IN PLACE (the reference donates them to its
jitted steps; here the step writes the buffers it was given). Recurrent
state is not: a step returns a new :class:`SSMCache` and leaves the one it
was given intact (the split step re-advances from the window-start state).

Out-of-range writes (past a non-ring cache, into an unmapped block, past
the logical length) are DROPPED, never clamped. A torch scatter has no
drop mode — an out-of-range index is a device-side assert, and filtering
the indices on the host would be a sync — so each layout carries one sink
the attention never reads: the dense buffers hold one extra batch row
(row ``B``) and the paged pool one extra block (block ``NB``, which no
block table ever maps). A dropped write lands in the sink. The public
views (``AttnCache.k`` …) exclude it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

# the position-ordered gather lives beside kernel B2, whose plain version
# it is part of
from ..kernels.decode_attn.paged import gather_layer_paged  # noqa: F401


@dataclass
class AttnCache:
    """Stacked over layers. ``k_buf``/``v_buf`` (L, B+1, S, Hkv, hd) and
    ``pm_buf`` (L, B+1, S) hold the sink row B; ``k``/``v``/``pos_map``
    are the (L, B, ...) views without it."""
    k_buf: torch.Tensor
    v_buf: torch.Tensor
    pm_buf: torch.Tensor
    ring: bool = False

    @property
    def batch(self) -> int:
        return self.k_buf.shape[1] - 1

    @property
    def slots(self) -> int:
        return self.k_buf.shape[2]

    @property
    def k(self) -> torch.Tensor:
        return self.k_buf[:, :self.batch]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[:, :self.batch]

    @property
    def pos_map(self) -> torch.Tensor:
        return self.pm_buf[:, :self.batch]


def init_attn_cache(n_layers: int, batch: int, slots: int, n_kv: int,
                    head_dim: int, dtype: torch.dtype, device,
                    ring: bool = False) -> AttnCache:
    shape = (n_layers, batch + 1, slots, n_kv, head_dim)
    return AttnCache(
        k_buf=torch.zeros(shape, dtype=dtype, device=device),
        v_buf=torch.zeros(shape, dtype=dtype, device=device),
        pm_buf=torch.full((n_layers, batch + 1, slots), -1, dtype=torch.int32,
                          device=device),
        ring=ring)


def update_layer_cache(k_buf: torch.Tensor, v_buf: torch.Tensor,
                       pm_buf: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: torch.Tensor,
                       ring: bool, slot_off: Optional[torch.Tensor] = None,
                       pos_off: Optional[torch.Tensor] = None) -> None:
    """Write a (B, T, Hkv, hd) window into one layer's cache (sink row
    included: k/v (B+1, S, Hkv, hd), pos_map (B+1, S)) at per-sequence
    positions ``pos`` (B,), in place.

    Non-ring writes past the cache edge (``pos + t >= S``) are dropped into
    the sink row; ring writes wrap (slot = position % S).

    ``slot_off``/``pos_off`` ((T,) int32, non-ring only) decouple the write
    slot ``pos + slot_off[t]`` from the stored position ``pos +
    pos_off[t]``: tree speculation puts sibling branches in distinct slots
    that share a position. None keeps slot == position == ``pos + t``."""
    B, T = k_new.shape[0], k_new.shape[1]
    S = k_buf.shape[1]
    dev = pos.device
    if slot_off is not None or pos_off is not None:
        assert not ring, "tree slot/pos decoupling needs a non-ring cache"
    s_off = (torch.arange(T, device=dev, dtype=pos.dtype)
             if slot_off is None else slot_off)
    p_off = s_off if pos_off is None else pos_off
    abs_pos = pos[:, None] + p_off[None, :]
    write_pos = pos[:, None] + s_off[None, :]
    slot = (write_pos % S if ring else write_pos).long()
    keep = (slot >= 0) & (slot < S)
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    rows = torch.where(keep, rows, B)                      # B = sink row
    slot = torch.where(keep, slot, 0)
    k_buf[rows, slot] = k_new.to(k_buf.dtype)
    v_buf[rows, slot] = v_new.to(v_buf.dtype)
    pm_buf[rows, slot] = abs_pos.to(torch.int32)


def tree_commit_cache(cache: AttnCache, pos: torch.Tensor,
                      path: torch.Tensor, n_acc: torch.Tensor,
                      n_entries: int) -> AttnCache:
    """Relocate a verified tree's winning path onto the linear slots and
    scrub the losers, in place, all layers at once (dense non-ring caches).

    Tree entry ``e`` lives at slot ``pos + e`` with position ``pos +
    tree_pos[e]``; accepted depth ``d < n_acc`` of the winning path (entry
    ``path[:, d]``) moves to slot ``pos + 1 + d`` with pos_map ``pos + 1 +
    d``. The path's K/V/pos_map are gathered BEFORE any write (sources and
    destinations overlap). Every other slot of ``(pos, pos + n_entries)``
    (the anchor slot excluded) gets pos_map −1; writes at ``d >= n_acc``
    (and past the cache) drop into the sink row; a source the proposer
    never wrote (pos_map < 0, the draft's tail hole) stays a hole. Done rows
    pass ``n_acc == 0`` and only scrub."""
    assert not cache.ring, "tree speculation needs a non-ring dense cache"
    B, S = cache.batch, cache.slots
    d_max = path.shape[1]
    dev = pos.device
    pos_l = pos.long()
    d_idx = torch.arange(d_max, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None].expand(B, d_max)
    src = (pos_l[:, None] + path.long()).clamp(0, S - 1)      # (B, d_max)
    kg = cache.k_buf[:, rows, src]                  # (L, B, d_max, Hkv, hd)
    vg = cache.v_buf[:, rows, src]
    pg = cache.pm_buf[:, rows, src]                 # (L, B, d_max)
    s_idx = torch.arange(S, device=dev)[None, :]
    region = (s_idx > pos_l[:, None]) & (s_idx < pos_l[:, None] + n_entries)
    cache.pm_buf[:, :B].masked_fill_(region[None], -1)
    dest = pos_l[:, None] + 1 + d_idx                          # (B, d_max)
    keep = (d_idx < n_acc[:, None]) & (dest < S)
    drow = torch.where(keep, rows, B)                          # B = sink row
    dest = torch.where(keep, dest, 0)
    cache.k_buf[:, drow, dest] = kg
    cache.v_buf[:, drow, dest] = vg
    cache.pm_buf[:, drow, dest] = torch.where(
        pg >= 0, (pos_l[:, None] + 1 + d_idx).to(torch.int32)[None],
        torch.full_like(pg, -1))
    return cache


# --------------------------------------------------------------------------
# Paged attention cache: shared block pool + per-slot block tables
# --------------------------------------------------------------------------

@dataclass
class PagedAttnCache:
    """Paged KV storage for the attention families.

    Pool buffers (shared across slots, sink block NB included):
    ``k_buf``/``v_buf`` (L, NB+1, bs, Hkv, hd) in the model dtype or int8,
    ``ks_buf``/``vs_buf`` (L, NB+1, bs, Hkv) f32 scales when quantized,
    ``pm_buf`` (L, NB+1, bs) int32 positions. ``block_table`` (B, n_log)
    int32 is shared by all layers: entry [b, i] is the pool block holding
    slot b's logical positions [i·bs, (i+1)·bs), or −1 (unmapped ⇒ writes
    drop, reads mask). ``length`` is the logical sequence capacity."""
    k_buf: torch.Tensor
    v_buf: torch.Tensor
    pm_buf: torch.Tensor
    block_table: torch.Tensor
    ring: bool = False
    length: int = 0
    ks_buf: Optional[torch.Tensor] = None
    vs_buf: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "PagedAttnCache":
        return replace(self, **kw)

    @property
    def n_blocks(self) -> int:
        return self.k_buf.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k_buf.shape[2]

    @property
    def n_logical_blocks(self) -> int:
        return self.block_table.shape[1]

    @property
    def slots(self) -> int:           # AttnCache parity (logical length)
        return self.length

    @property
    def quantized(self) -> bool:
        return self.ks_buf is not None

    # views without the sink block
    @property
    def k(self) -> torch.Tensor:
        return self.k_buf[:, :self.n_blocks]

    @property
    def v(self) -> torch.Tensor:
        return self.v_buf[:, :self.n_blocks]

    @property
    def pos_map(self) -> torch.Tensor:
        return self.pm_buf[:, :self.n_blocks]

    @property
    def k_scale(self) -> Optional[torch.Tensor]:
        return None if self.ks_buf is None else self.ks_buf[:, :self.n_blocks]

    @property
    def v_scale(self) -> Optional[torch.Tensor]:
        return None if self.vs_buf is None else self.vs_buf[:, :self.n_blocks]


def logical_blocks(length: int, block_size: int) -> int:
    """Blocks needed to cover ``length`` logical positions."""
    return math.ceil(length / block_size)


def init_paged_attn_cache(n_layers: int, batch: int, length: int,
                          n_blocks: int, block_size: int, n_kv: int,
                          head_dim: int, dtype: torch.dtype, device,
                          quantize: bool = False,
                          ring: bool = False) -> PagedAttnCache:
    n_log = logical_blocks(length, block_size)
    kv_dtype = torch.int8 if quantize else dtype
    pool = (n_layers, n_blocks + 1, block_size)
    scale = (torch.zeros((*pool, n_kv), dtype=torch.float32, device=device)
             if quantize else None)
    return PagedAttnCache(
        k_buf=torch.zeros((*pool, n_kv, head_dim), dtype=kv_dtype,
                          device=device),
        v_buf=torch.zeros((*pool, n_kv, head_dim), dtype=kv_dtype,
                          device=device),
        pm_buf=torch.full(pool, -1, dtype=torch.int32, device=device),
        block_table=torch.full((batch, n_log), -1, dtype=torch.int32,
                               device=device),
        ring=ring, length=length, ks_buf=scale,
        vs_buf=None if scale is None else torch.zeros_like(scale))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entry symmetric int8 over the head dim: x (..., hd) →
    (int8 (..., hd), f32 scale (...,))."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def paged_update_layer(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_scale: Optional[torch.Tensor],
                       v_scale: Optional[torch.Tensor],
                       pos_map: torch.Tensor, block_table: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor, ring: bool, length: int) -> None:
    """Write a (B, T, Hkv, hd) window into ONE layer's pool (sink block
    included: k/v (NB+1, bs, Hkv, hd), pos_map (NB+1, bs)) through the
    block table, in place.

    Logical slot = pos (ring: pos % length); the write lands at
    ``block_table[b, slot // bs] · bs + slot % bs`` of the flattened pool.
    Writes to unmapped blocks (−1) or past ``length`` drop into the sink
    block, so a paged slot and a dense row diverge on nothing."""
    B, T = k_new.shape[0], k_new.shape[1]
    NB, bs = k_pool.shape[0] - 1, k_pool.shape[1]
    n_log = block_table.shape[1]
    dev = pos.device
    abs_pos = pos[:, None] + torch.arange(T, device=dev,
                                          dtype=pos.dtype)[None, :]
    logical = (abs_pos % length if ring else abs_pos).long()
    blk = torch.div(logical, bs, rounding_mode="floor")
    off = logical - blk * bs
    phys = torch.gather(block_table, 1,
                        blk.clamp(0, n_log - 1)).long()
    invalid = (phys < 0) | (logical < 0) | (logical >= length) \
        | (blk >= n_log)
    flat = torch.where(invalid, NB * bs, phys * bs + off)   # sink ⇒ drop
    kf = k_pool.view(-1, *k_pool.shape[2:])
    vf = v_pool.view(-1, *v_pool.shape[2:])
    if k_scale is not None:
        k_q, k_s = quantize_kv(k_new)
        v_q, v_s = quantize_kv(v_new)
        kf[flat] = k_q
        vf[flat] = v_q
        k_scale.view(-1, k_scale.shape[-1])[flat] = k_s
        v_scale.view(-1, v_scale.shape[-1])[flat] = v_s
    else:
        kf[flat] = k_new.to(k_pool.dtype)
        vf[flat] = v_new.to(v_pool.dtype)
    pos_map.view(-1)[flat] = abs_pos.to(torch.int32)


def paged_insert_row(pool: PagedAttnCache, row: AttnCache,
                     block_ids: torch.Tensor, slot: torch.Tensor) -> None:
    """Admission: scatter a freshly prefilled DENSE cache row (batch 1,
    S == pool.length) into the pool blocks ``block_ids`` ((n_log,) int32,
    −1 = unreserved tail) and point ``block_table[slot]`` at them, in
    place. ``slot`` is a (1,) int64 index on the pool's device: a device
    value, so a captured admission serves any slot. Every mapped block gets
    its k/v/pos_map fully rewritten (the padded row tail carries pos −1), so
    a reused block can never leak its previous tenant's entries."""
    L, S = row.k_buf.shape[0], row.k_buf.shape[2]
    NB, bs = pool.n_blocks, pool.block_size
    n_log = block_ids.shape[0]
    padS = n_log * bs
    assert S <= padS, (S, padS)

    def blocks_of(x, fill):
        x = x[:, 0]                                    # (L, S, ...)
        pad = x.new_full((L, padS - S, *x.shape[2:]), fill)
        x = torch.cat([x, pad], dim=1)
        return x.reshape(L, n_log, bs, *x.shape[2:])

    ids = block_ids.to(device=pool.k_buf.device, dtype=torch.long)
    idx = torch.where(ids >= 0, ids, NB)               # −1 ⇒ sink block
    k_b = blocks_of(row.k_buf, 0)
    v_b = blocks_of(row.v_buf, 0)
    pm_b = blocks_of(row.pm_buf, -1)
    if pool.quantized:
        k_b, ks_b = quantize_kv(k_b)
        v_b, vs_b = quantize_kv(v_b)
        pool.ks_buf[:, idx] = ks_b
        pool.vs_buf[:, idx] = vs_b
    pool.k_buf[:, idx] = k_b.to(pool.k_buf.dtype)
    pool.v_buf[:, idx] = v_b.to(pool.v_buf.dtype)
    pool.pm_buf[:, idx] = pm_b
    pool.block_table.index_copy_(0, slot, ids[None].to(torch.int32))


def paged_release_slot(pool: PagedAttnCache, slot: int) -> None:
    """Retirement: unmap a slot's block-table row (−1 ⇒ the frozen slot's
    ongoing speculative window writes drop). MUST run before the slot's
    blocks return to the allocator."""
    pool.block_table[slot] = -1


class BlockAllocator:
    """Host-side free-list allocator over the pool's physical blocks.

    Blocks are unit-sized so there is no external fragmentation; a block is
    never handed to two live reservations, free + allocated always
    partition ``[0, n_blocks)``, and ``alloc`` fails exactly when fewer
    than ``n`` blocks are free. LIFO reuse keeps recently-touched blocks
    hot."""

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, -1, -1))  # pop() → 0 first
        self._used: set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} free "
                f"of {self.n_blocks}")
        ids = [self._free.pop() for _ in range(n)]
        self._used.update(ids)
        return ids

    def free(self, ids) -> None:
        for i in ids:
            i = int(i)
            if i < 0:
                continue               # padded (unreserved) table entries
            assert i in self._used, f"double free of block {i}"
            self._used.remove(i)
            self._free.append(i)


# --------------------------------------------------------------------------
# Recurrent (Mamba2) state and the hybrid cache
# --------------------------------------------------------------------------

@dataclass
class SSMCache:
    """Mamba2 recurrent state, stacked over layers: ``conv`` (L, B, K−1,
    conv_dim) the short-conv input tails, ``state`` (L, B, nh, hd, N) f32
    the SSD states."""
    conv: torch.Tensor
    state: torch.Tensor


def init_ssm_cache(n_layers: int, batch: int, conv_width: int,
                   conv_dim: int, n_heads: int, head_dim: int,
                   d_state: int, dtype: torch.dtype, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((n_layers, batch, conv_width - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((n_layers, batch, n_heads, head_dim, d_state),
                          dtype=torch.float32, device=device))


@dataclass
class HybridCacheT:
    """Zamba2-style hybrid: the SSM cache of the Mamba2 backbone and one
    dense attention cache whose L axis counts the shared block's calls
    (``max(1, n_seg)``)."""
    ssm: SSMCache
    shared_attn: AttnCache


# --------------------------------------------------------------------------
# Slot recycling (continuous batching)
# --------------------------------------------------------------------------

def _batch_rows(cache) -> list:
    """(buffer, init fill) of every leaf whose axis 1 is the batch row."""
    if isinstance(cache, HybridCacheT):
        return _batch_rows(cache.ssm) + _batch_rows(cache.shared_attn)
    if isinstance(cache, SSMCache):
        return [(cache.conv, 0), (cache.state, 0)]
    if isinstance(cache, AttnCache):
        return [(cache.k_buf, 0), (cache.v_buf, 0), (cache.pm_buf, -1)]
    raise TypeError(f"no batch rows in {type(cache).__name__}")


def insert_slot(dst, src, slot: torch.Tensor) -> None:
    """Write batch row 0 of every leaf of ``src`` into batch row ``slot`` (a
    (1,) int64 index on the cache's device) of the matching leaf of
    ``dst``, in place (one layer-stacked copy per leaf): dense attention,
    SSM and hybrid caches. Paged caches take :func:`paged_insert_row`."""
    for (d, _), (s, _) in zip(_batch_rows(dst), _batch_rows(src)):
        d.index_copy_(1, slot, s[:, :1])


def reset_slot(cache, slot: int) -> None:
    """Scrub batch row ``slot`` of a dense, SSM or hybrid cache back to its
    init state (k/v/conv/state zeroed, pos_map −1), in place. Insertion
    already overwrites a slot fully, so this is hygiene for long-lived
    sessions. Paged caches are left untouched (their batch dim is the
    block table, handled by :func:`paged_release_slot`)."""
    if isinstance(cache, PagedAttnCache):
        return
    for buf, fill in _batch_rows(cache):
        buf[:, slot] = fill
