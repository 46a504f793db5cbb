"""Device-resident decode state for the fused decode loop (port of
repro/serving/device_state.py; DESIGN.md §5).

Host scheduling still decides which request sits in which slot; what the
decode loop reads — last token, KV position, remaining-token budget,
block-table row — lives on the card and is updated by small delta
scatters when requests join, grow their page list, or get their budget
clamped or restored, instead of being rebuilt from host metadata every
step.

Unlike repro's functional state, these tensors stay at fixed addresses:
they are the static inputs of the captured fused-loop graphs
(core/residency.py), which advance them in place. The executor keeps one
state per batch rung for the life of the engine (both layouts read the
same `(Dd, B)` rows) and `reset`s it where repro builds a fresh one. The
deltas reach the card through `Staged` buffers: a pinned host buffer
copied without a synchronisation, so a scatter never waits for the fused
loop that is still running.
"""
from __future__ import annotations

import numpy as np
import torch


class Staged:
    """A host buffer and its device twin, both at fixed addresses. Fill the
    numpy view `acquire()` returns, then `upload(n)` copies its first n
    rows (all by default) to the card without blocking the host. On a card
    the host buffer is pinned, and `acquire` first waits until the card
    has read the previous upload (an event recorded after it), so a
    one-deep pipeline never overwrites bytes still in flight."""

    def __init__(self, shape, device, dtype=torch.int32):
        device = torch.device(device)
        cuda = device.type == "cuda"
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._host = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        self.host = self._host.numpy()
        self._read = torch.cuda.Event() if cuda else None

    def acquire(self) -> np.ndarray:
        if self._read is not None:
            self._read.synchronize()
        return self.host

    def upload(self, n: int | None = None) -> torch.Tensor:
        src, dst = ((self._host, self.dev) if n is None
                    else (self._host[:n], self.dev[:n]))
        dst.copy_(src, non_blocking=True)
        if self._read is not None:
            self._read.record()
        return dst


class DeviceDecodeState:
    """One decode rung's device-resident state and its host occupancy
    mirror (`slot_rid`, -1 = free). Rows are `(Dd, B)`; slot-sharded
    layouts read slot s on rank s // (B // G), as the step does."""

    def __init__(self, layout, Dd: int, B: int, maxp: int, device):
        self.layout, self.Dd, self.B, self.maxp = layout, Dd, B, maxp
        z = dict(dtype=torch.int32, device=device)
        self.tokens = torch.zeros((Dd, B), **z)
        self.positions = torch.zeros((Dd, B), **z)
        self.budgets = torch.zeros((Dd, B), **z)
        self.block_tables = torch.zeros((Dd, B, maxp), **z)
        self.slot_rid = np.full((Dd, B), -1, np.int64)
        # one row per slot: (d, s, token, position, budget, table row)
        self._join = Staged((Dd * B, 5 + maxp), device)
        self._grow = Staged((Dd * B, 3 + maxp), device)

    def reset(self, layout) -> None:
        """Empty every slot for `layout` (repro builds a fresh state)."""
        self.layout = layout
        for t in (self.tokens, self.positions, self.budgets,
                  self.block_tables):
            t.zero_()
        self.slot_rid.fill(-1)

    # ------------------------------------------------------------------
    def free_slot(self, d: int, lo: int, hi: int) -> int | None:
        """First free slot index in [lo, hi) of data group d."""
        for s in range(lo, hi):
            if self.slot_rid[d, s] < 0:
                return s
        return None

    def _bt_row(self, pages: list[int]) -> np.ndarray:
        row = np.zeros(self.maxp, np.int32)
        n = min(len(pages), self.maxp)
        row[:n] = pages[:n]
        return row

    def _in_range(self, d: int, s: int) -> bool:
        return 0 <= d < self.Dd and 0 <= s < self.B

    def apply(self, joins: list, grows: list) -> None:
        """Apply host-side deltas to the device tensors, in place.

        joins: (d, s, token, position, budget, pages) — new occupants;
        grows: (d, s, budget, pages) — page growth / budget updates for
        slots whose token and position are already right on the card.
        Rows whose slot is out of range are dropped, as repro's scatters
        drop them (`mode="drop"`); the rest go up in one upload per kind
        and land with `index_put_`."""
        joins = [j for j in joins if self._in_range(j[0], j[1])]
        grows = [g for g in grows if self._in_range(g[0], g[1])]
        cap = self.Dd * self.B
        for b in range(0, len(joins), cap):
            blk = joins[b:b + cap]
            h = self._join.acquire()
            for i, (d, s, tok, pos, bud, pages) in enumerate(blk):
                h[i, :5] = (d, s, tok, pos, bud)
                h[i, 5:] = self._bt_row(pages)
            v = self._join.upload(len(blk))
            idx = (v[:, 0].long(), v[:, 1].long())
            self.tokens.index_put_(idx, v[:, 2])
            self.positions.index_put_(idx, v[:, 3])
            self.budgets.index_put_(idx, v[:, 4])
            self.block_tables.index_put_(idx, v[:, 5:])
        for b in range(0, len(grows), cap):
            blk = grows[b:b + cap]
            h = self._grow.acquire()
            for i, (d, s, bud, pages) in enumerate(blk):
                h[i, :3] = (d, s, bud)
                h[i, 3:] = self._bt_row(pages)
            v = self._grow.upload(len(blk))
            idx = (v[:, 0].long(), v[:, 1].long())
            self.budgets.index_put_(idx, v[:, 2])
            self.block_tables.index_put_(idx, v[:, 3:])
