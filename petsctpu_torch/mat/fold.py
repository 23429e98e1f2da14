"""Deterministic scatter-add: a fold plan over the slots of a target.

petsctpu's scatter-adds (`y.at[targets].add(contrib)`) fold on XLA:CPU
one update at a time, in the order of the flattened slots. On the card
`index_add_` adds through atomics in an order that changes from call to
call, so a solver's residual stream would differ from run to run.

FoldPlan lists, at setup, the slots that land on each target in
ascending slot order, grouped by their rank among the target's slots.
`fold(start, contrib)` then adds rank 0's slots into their targets, then
rank 1's, and so on: each target is folded in petsctpu's order
(start + c_first + c_second + ...), so the CPU's bits equal XLA:CPU's,
and within one rank every target is written once, so the card is
deterministic. The rank count is the widest target's slot count.

Slots that `keep` marks False are left out of the plan: callers drop
the slots whose contribution is an exact zero (ELL padding, SBAIJ's
diagonal slots), which keeps the rank count at the pattern's real width.
Leaving out a ±0 changes a fold only where the sum so far is −0.0.
"""

from __future__ import annotations

import math

import torch


class FoldPlan:
    """src/tgt [N_kept] int64 in rank order; offsets[j] the first entry
    of rank j (host ints)."""

    def __init__(self, src: torch.Tensor, tgt: torch.Tensor, offsets):
        self.src = src
        self.tgt = tgt
        self.offsets = tuple(int(o) for o in offsets)
        self._wide = {1: (src, tgt)}

    @property
    def ranks(self) -> int:
        return len(self.offsets) - 1

    def _scalar(self, w: int):
        """(src, tgt) as scalar indices into rows of w values, each
        slot's w entries side by side: gathers of single values, which
        run far faster on the card than gathers of short rows
        (scripts/bench_formats.py: 0.053 against 0.634 ms for 1 M fp64
        pairs)."""
        if w not in self._wide:
            lane = torch.arange(w, device=self.src.device)
            self._wide[w] = tuple((a[:, None] * w + lane).reshape(-1)
                                  for a in (self.src, self.tgt))
        return self._wide[w]

    def fold(self, start: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
        """start [T, ...] plus, at each target, its slots' rows of
        contrib [N, ...] in slot order. Out of place."""
        w = math.prod(contrib.shape[1:])
        src, tgt = self._scalar(w)
        y = start.reshape(-1).clone()
        c = contrib.reshape(-1)
        for j in range(self.ranks):
            s, e = w * self.offsets[j], w * self.offsets[j + 1]
            t = tgt[s:e]
            y.index_put_((t,), y.index_select(0, t)
                         + c.index_select(0, src[s:e]))
        return y.view(start.shape)


def fold_plan(targets: torch.Tensor, keep: torch.Tensor = None) -> FoldPlan:
    """The plan of flat `targets` [N] (slot s lands on targets[s]),
    built on the targets' device; `keep` [N] bool leaves slots out."""
    targets = targets.reshape(-1).to(torch.int64)
    dev = targets.device
    slots = torch.arange(targets.numel(), device=dev)
    if keep is not None:
        slots = slots[keep.reshape(-1)]
    t = targets[slots]
    # slots by (target, slot): a stable sort keeps ascending slot order
    t_sorted, order = torch.sort(t, stable=True)
    slots = slots[order]
    n = t_sorted.numel()
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n:
        first[1:] = t_sorted[1:] != t_sorted[:-1]
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                         0).values if n else pos
    rank = pos - start
    # then by (rank, target): each rank's targets are unique
    rank_sorted, order2 = torch.sort(rank, stable=True)
    counts = torch.bincount(rank_sorted) if n else rank_sorted
    offsets = [0]
    for c in counts.tolist():
        offsets.append(offsets[-1] + c)
    return FoldPlan(slots[order2], t_sorted[order2], offsets)
