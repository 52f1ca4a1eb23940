"""Engine-owned slot pools: the device side of a decode session, kept by
the engine across sessions so that its captured graphs are too — the torch
form of the reference engine's ``_jit_cache`` (``repro/core/engine.py``),
where a new session of known shapes compiles nothing.

A :class:`SlotPool` owns everything a session's captured steps read or
write: the :class:`~repro_torch.core.specdec.SpecDecodeState` (caches,
``last_token``, ``pos``), the lifecycle and stats buffers (output buffer,
cursors, budgets, done flags, the ``sync_every`` stats rows, the tree
counters), the per-round tables and static step inputs, the device
generator, the side stream of warm-ups and captures, the paged block
allocators, the transport rounds' buffers, and the
:class:`~repro_torch.core.capture.CapturedStep` objects themselves (round,
insert, tree, the split workers' steps).

Pools are keyed by geometry (:meth:`DecodeSession._geometry`): every value
a captured step was built for — capacity, output width, prompt pad bound
or a wave's slot length, the paged layout, γ_max, ``sync_every``,
``max_branches``, the transport step set, T > 0 or not, capture or eager,
an encoder's frame count. :meth:`SpecDecodeEngine.lease_pool` hands a
session a pool of its geometry that no live session holds, building one
when none is free, and :meth:`SlotPool.reset` returns it to what a fresh
session would have built: every slot free and done, cursors 0, the output
buffer −1, no cache position visible (``pos_map`` −1, block tables
unmapped), recurrent state zeroed, a fresh block allocator per paged side,
and the generator re-seeded from the session's ``seed``. Two live sessions
never share a pool. Pools live as long as their engine; nothing else keeps
them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.kvcache import BlockAllocator, reset_cache


class SlotPool:
    """The device buffers and captured steps of one session geometry.

    ``capacity`` batch rows, ``max_new_cap`` output columns, ``sync_every``
    stats rows, ``gamma_max``/``max_branches`` the round tables' bounds,
    ``capture`` whether its steps capture (a stream is made for them).
    ``state`` and ``blocks`` (pool blocks per paged side, 0 for a side
    that does not page) are set by the first session that leases the
    pool; ``steps`` and ``wire`` fill as its sessions call steps."""

    def __init__(self, key: tuple, device: torch.device, capacity: int,
                 max_new_cap: int, sync_every: int, gamma_max: int,
                 max_branches: int, capture: bool):
        self.key = key
        self.leased = False
        self.state = None
        self.blocks = {"draft": 0, "target": 0}     # 0: not paged
        self.alloc: dict[str, Optional[BlockAllocator]] = {}
        self.steps: dict = {}              # "round", "insert"
        self.wire: Optional[dict] = None   # transport buffers; its "steps"
                                           # the worker programs
        self.gen = torch.Generator(device=device)
        self.stream = torch.cuda.Stream(device) if capture else None
        B, dev = capacity, device
        i32 = dict(dtype=torch.int32, device=dev)
        # one column past max_new_cap: the drop sink of _accumulate
        self.out_buf = torch.full((B, max_new_cap + 1), -1, **i32)
        self.cursor = torch.zeros((B,), **i32)
        self.max_new = torch.zeros((B,), **i32)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        self.nacc = torch.zeros((sync_every, B), **i32)
        self.nn = torch.zeros((sync_every, B), **i32)
        # per-round scalars: tables on the device, and the round step's
        # static inputs, filled from them by one device-to-device copy each
        self.gamma_tab = torch.arange(gamma_max + 1, **i32)
        self.branch_tab = torch.arange(max_branches + 1, **i32)
        self.row_tab = torch.arange(sync_every, dtype=torch.long, device=dev)
        self.gamma_in = torch.zeros((), **i32)
        self.branch_in = torch.zeros((), **i32)
        self.row_in = torch.zeros((), dtype=torch.long, device=dev)
        self.eos = torch.full((), -1, **i32)
        # the tree verdict's per-row counters (tree_verify_fused): left at
        # zero by every launch
        self.tree_counters = (torch.zeros((B,), **i32) if max_branches
                              else None)

    def reset(self, seed: int, eos_id: int) -> None:
        """Every slot free: done, cursor 0, budget 0, output −1, stats rows
        0, no cache position visible and recurrent state zeroed, a fresh
        allocator per paged side, the EOS id, and the generator re-seeded
        (``manual_seed`` also reaches a generator registered with a graph:
        each replay reads its seed and offset)."""
        self.out_buf.fill_(-1)
        self.cursor.zero_()
        self.max_new.zero_()
        self.done.fill_(True)
        self.nacc.zero_()
        self.nn.zero_()
        self.eos.fill_(int(eos_id))
        if self.tree_counters is not None:
            self.tree_counters.zero_()
        if self.state is not None:
            reset_cache(self.state.draft_cache)
            reset_cache(self.state.target_cache)
            self.state.last_token.zero_()
            self.state.pos.zero_()
        self.alloc = {side: (BlockAllocator(n) if n else None)
                      for side, n in self.blocks.items()}
        self.gen.manual_seed(int(seed))

    def release(self) -> None:
        self.leased = False
