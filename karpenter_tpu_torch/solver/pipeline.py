"""The batched paths' two-stage chunk pipeline and the speculative chunk
chain on the card.

The port of `karpenter_tpu/solver/pipeline.py` for the consolidation sweep,
the generic batched solve and the G-axis chunk chain:

- **two-stage chunk pipeline** (`run_pipeline`, as the reference's): while
  chunk *i* runs on the card, chunk *i+1* builds its rows, uploads and
  launches; chunk *i*'s pull and decode run after *i+1*'s dispatch.
  In-flight depth is bounded at ONE undecoded chunk.
- **staging buffers** (`ChunkStaging`, the counterpart of the reference's
  donated `DeviceSlots`; PyTorch has no buffer donation): dispatch writes a
  chunk's per-problem rows into one of two alternating pinned host
  buffers, copies them to the card asynchronously and launches; it then
  enqueues the result's copy back into pinned memory and records a CUDA
  event.  The complete stage waits on that chunk's event only.  The slots
  rotate (two for the pipeline, one per in-flight chunk for the chain) and
  each upload slot waits on the event of the copy that last read it, so a
  chunk's upload never overwrites host rows a copy may still be reading.
- **speculative chunk chain** (`run_spec_chain`, as the reference's): the
  pipeline generalised to a chain of seeded solves whose successors
  dispatch from a speculated entry state and are flushed and re-dispatched
  when the speculation was wrong.

Gating: `KARPENTER_TPU_PIPELINE` — `off`/`0`/`false` runs each chunk to
the end before the next starts, `on`/`1`/`true` forces the pipeline, and
anything else (unset, malformed) resolves from the solver's device: on
for a CUDA device, off for the CPU, where the "device" work shares the
host's cores.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import firstuse


def pipeline_enabled(device: torch.device) -> bool:
    """Resolve the pipeline gate (see module docstring) for a solver on
    `device`.  Re-read per call, so tests and operators can flip it
    without rebuilding the solver."""
    raw = os.environ.get("KARPENTER_TPU_PIPELINE", "auto").strip().lower()
    if raw in ("off", "0", "false"):
        return False
    if raw in ("on", "1", "true"):
        return True
    return torch.device(device).type == "cuda"


class ChunkStaging:
    """`depth` rotating pinned host buffers per direction (two by default)
    for a pipelined chunk loop on a CUDA device.  A pull slot is reused
    `depth` pulls later, so at most `depth` results may be waiting to be
    read.

    `upload(arrays, device)` packs 4-byte numpy arrays into the next
    upload slot, copies it to the card with `non_blocking=True` and
    returns typed device views (the signature of `ffd._upload`).
    `pull(flat)` enqueues the copy of a result tensor into the next pull
    slot and returns a handle; `wait(handle)` blocks on that copy's event
    only and returns the host rows (a numpy copy: the slot is reused
    `depth` chunks later)."""

    def __init__(self, depth: int = 2):
        depth = max(depth, 2)
        self._up: List[Optional[torch.Tensor]] = [None] * depth
        self._up_ev: List[Optional[torch.cuda.Event]] = [None] * depth
        self._down: List[Optional[torch.Tensor]] = [None] * depth
        self._most_up = self._most_down = 0
        self._i = 0
        self._j = 0

    @staticmethod
    def _pinned(buf: Optional[torch.Tensor], n: int,
                dtype: torch.dtype) -> torch.Tensor:
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
            firstuse.note("pinned")
        return buf

    def reserve(self) -> None:
        """Size every slot to the largest upload and pull seen so far, so
        later chunks up to those sizes allocate no pinned memory (the
        solver's warm-up runs its chunks, then reserves)."""
        for i in range(len(self._up)):
            self._up[i] = self._pinned(self._up[i], self._most_up,
                                       torch.int32)
            self._down[i] = self._pinned(self._down[i], self._most_down,
                                         torch.float32)

    def occupancy(self) -> int:
        """Upload slots holding a pinned buffer — the counterpart of the
        reference's donated-slot occupancy.  Telemetry only
        (`karpenter_tpu_solver_donated_slots_in_use`); never consulted by
        the rotation itself."""
        return sum(1 for buf in self._up if buf is not None)

    def upload(self, arrays: Sequence[np.ndarray],
               device: torch.device) -> Tuple[torch.Tensor, ...]:
        from karpenter_tpu_torch.solver.ffd import typed_views
        self._i = (self._i + 1) % len(self._up)
        i = self._i
        if self._up_ev[i] is not None:
            # the copy that last read this slot must be done before the
            # host overwrites it
            self._up_ev[i].synchronize()
        sizes = [int(np.prod(a.shape)) for a in arrays]
        total = sum(sizes)
        self._most_up = max(self._most_up, total)
        host = self._pinned(self._up[i], total, torch.int32)
        self._up[i] = host
        view = host.numpy()
        off = 0
        for a, n in zip(arrays, sizes):
            a = np.ascontiguousarray(a)
            assert a.dtype in (np.float32, np.int32), a.dtype
            view[off:off + n] = a.reshape(-1).view(np.int32)
            off += n
        buf = torch.empty(total, dtype=torch.int32, device=device)
        buf.copy_(host[:total], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._up_ev[i] = ev
        return typed_views(buf, arrays)

    def pull(self, flat: torch.Tensor):
        self._j = (self._j + 1) % len(self._down)
        j = self._j
        self._most_down = max(self._most_down, flat.numel())
        host = self._pinned(self._down[j], flat.numel(), flat.dtype)
        self._down[j] = host
        out = host[:flat.numel()].view(flat.shape)
        out.copy_(flat, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return out, ev

    @staticmethod
    def wait(handle) -> np.ndarray:
        out, ev = handle
        ev.synchronize()
        return out.numpy().copy()


def run_pipeline(items: Iterable, dispatch: Callable, complete: Callable,
                 enabled: bool = True) -> None:
    """Two-stage dispatch/complete pipeline over `items`.

    `dispatch(item) -> handle` must only ENQUEUE device work (encode,
    upload, async dispatch); `complete(item, handle)` pulls and decodes.
    With `enabled`, chunk *i* completes after chunk *i+1* dispatches, so
    its pull overlaps *i+1*'s device execution; in-flight depth is
    bounded at one undecoded chunk.  Disabled, each item completes
    before the next dispatches — the synchronous rollback order.
    """
    if not enabled:
        for item in items:
            complete(item, dispatch(item))
        return
    pending: Optional[Tuple] = None
    for item in items:
        handle = dispatch(item)
        if pending is not None:
            complete(*pending)
        pending = (item, handle)
    if pending is not None:
        complete(*pending)


# -- the speculative chunked G-axis chain ------------------------------------

# in-flight speculation slots: chunk k's device step can cover at most
# depth-1 speculative dispatches ahead of it, so deeper windows only add
# wasted work on a mispredict
SPEC_DEPTH = 3


def run_spec_chain(n: int, seed0, dispatch: Callable, project: Callable,
                   commit: Callable, match: Callable,
                   depth: int = SPEC_DEPTH):
    """The two-stage pipeline generalised to a K-deep chain of SEEDED
    solves with speculate-and-repair (the G-axis chunk chain).

    - ``dispatch(k, seed) -> handle`` enqueues chunk ``k``'s seeded solve
      from entry state ``seed`` (asynchronous — must not block).
    - ``project(k, seed) -> seed | None`` speculates chunk ``k``'s EXIT
      state from its entry, so chunk ``k+1`` can dispatch before ``k``
      commits; ``None`` declines (the chain stalls until the truth).
    - ``commit(k, seed, handle) -> seed | None`` blocks for chunk ``k``'s
      output and returns its TRUE exit state; ``None`` aborts the whole
      chain (the caller falls back to the single program, counted).
    - ``match(speculated, true) -> bool`` is the bit-exact seed comparison.

    Returns ``(ok, outcomes, flushed)``: ``outcomes`` has one entry per
    chunk AFTER the first — ``"committed"`` when the successor's speculated
    entry matched the true exit (its in-flight solve IS the sequential
    program's), ``"repaired"`` when it diverged or speculation was declined
    and the successor (re-)dispatched from the true seed.  A divergence
    flushes ALL in-flight successors; their launches still run on the
    stream, so their handles come back in ``flushed`` for the caller to
    keep alive until the stream has passed them — they are never read.
    """
    from collections import deque
    depth = max(depth, 1)
    inflight: deque = deque()   # (k, entry_seed, handle)
    outcomes: List[str] = []
    flushed: List = []
    next_k, next_entry = 0, seed0
    while next_k < n or inflight:
        while (next_k < n and len(inflight) < depth
               and next_entry is not None):
            inflight.append((next_k, next_entry,
                             dispatch(next_k, next_entry)))
            entry = next_entry
            next_k += 1
            next_entry = (project(next_k - 1, entry)
                          if next_k < n else None)
        k, entry, handle = inflight.popleft()
        true_exit = commit(k, entry, handle)
        if true_exit is None:
            flushed.extend(h for _, _, h in inflight)
            return False, outcomes, flushed
        if k + 1 < n:
            if inflight:
                # chunk k+1 is in flight on a speculated entry
                if match(inflight[0][1], true_exit):
                    outcomes.append("committed")
                else:
                    # divergence: every in-flight successor chains off the
                    # wrong state — flush them all and re-dispatch from
                    # the truth (the counted repair)
                    outcomes.append("repaired")
                    flushed.extend(h for _, _, h in inflight)
                    inflight.clear()
                    next_k, next_entry = k + 1, true_exit
            else:
                # speculation declined (or the window drained): the
                # successor never ran ahead — sequential for this boundary,
                # counted with the repairs so committed + repaired always
                # sums to chunks - 1
                outcomes.append("repaired")
                next_entry = true_exit
    return True, outcomes, flushed
