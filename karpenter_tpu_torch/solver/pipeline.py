"""The batched paths' two-stage chunk pipeline on the card.

The port of `karpenter_tpu/solver/pipeline.py` for the consolidation sweep
and the generic batched solve:

- **two-stage chunk pipeline** (`run_pipeline`, as the reference's): while
  chunk *i* runs on the card, chunk *i+1* builds its rows, uploads and
  launches; chunk *i*'s pull and decode run after *i+1*'s dispatch.
  In-flight depth is bounded at ONE undecoded chunk.
- **staging buffers** (`ChunkStaging`, the counterpart of the reference's
  donated `DeviceSlots`; PyTorch has no buffer donation): dispatch writes a
  chunk's per-problem rows into one of two alternating pinned host
  buffers, copies them to the card asynchronously and launches; it then
  enqueues the result's copy back into pinned memory and records a CUDA
  event.  The complete stage waits on that chunk's event only.  The two
  slots alternate, so a chunk's upload never overwrites the host rows of
  the chunk before it while that copy may still be in flight.

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
    """Two alternating pinned host buffers per direction for a pipelined
    chunk loop on a CUDA device.

    `upload(arrays, device)` packs 4-byte numpy arrays into the next
    upload slot, copies it to the card with `non_blocking=True` and
    returns typed device views (the signature of `ffd._upload`).
    `pull(flat)` enqueues the copy of a result tensor into the next pull
    slot and returns a handle; `wait(handle)` blocks on that copy's event
    only and returns the host rows (a numpy copy: the slot is reused two
    chunks later)."""

    def __init__(self):
        self._up: List[Optional[torch.Tensor]] = [None] * 2
        self._up_ev: List[Optional[torch.cuda.Event]] = [None] * 2
        self._down: List[Optional[torch.Tensor]] = [None] * 2
        self._i = 0
        self._j = 0

    @staticmethod
    def _pinned(buf: Optional[torch.Tensor], n: int,
                dtype: torch.dtype) -> torch.Tensor:
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
        return buf

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
