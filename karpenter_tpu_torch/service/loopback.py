"""In-process kt_solverd stand-in: the real wire framing, the C++
batching-window semantics, and the real backend — no native toolchain.

The port's copy of `karpenter_tpu/service/loopback.py`, over the port's
backend.  `LoopbackSolverd` re-implements native/solverd.cc's runtime in
plain Python threads: a unix-socket listener, per-connection reader
threads feeding one bounded window queue, and a single batcher thread
that collects a window (first request opens it; it closes on an idle
gap, the max-window wall, or the max batch size) and hands the whole
batch to `backend.handle_batch(payloads, conn_ids, backlog)` — the same
three-argument seam the daemon uses, so the tenant scheduler's
per-connection default tenants and backpressure hints behave
identically.  `SolverServiceClient` connects to it unchanged.

This is the test seam of the multi-tenant dispatch layer: the
scheduler's end-to-end tests drive real concurrent clients through a
real window without starting the native binary.  It is NOT the
deployment shape — the C++ daemon owns the card in production.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from collections import deque
from typing import Optional

_MAX_FRAME = 256 << 20  # mirror of the daemon's kMaxFrame


class _Window:
    """The C++ Batcher's queue + condition, in Python."""

    def __init__(self, idle_ms: float, max_ms: float, max_batch: int):
        self.idle_s = idle_ms / 1e3
        self.max_s = max_ms / 1e3
        self.max_batch = max_batch
        self.cv = threading.Condition()
        self.queue: deque = deque()  # (conn, conn_id, rid, payload)
        self.stopping = False

    def push(self, entry) -> None:
        with self.cv:
            self.queue.append(entry)
            self.cv.notify()

    def collect(self):
        """One window's batch + the backlog left behind it — the same
        trigger → wait-for-idle → drain shape as collect_batch()."""
        with self.cv:
            self.cv.wait_for(lambda: self.stopping or self.queue)
            batch = []
            if self.stopping and not self.queue:
                return batch, 0
            window_end = time.monotonic() + self.max_s
            while True:
                while self.queue and len(batch) < self.max_batch:
                    batch.append(self.queue.popleft())
                if len(batch) >= self.max_batch or self.stopping:
                    break
                now = time.monotonic()
                if now >= window_end:
                    break
                if not self.cv.wait_for(
                        lambda: self.queue or self.stopping,
                        timeout=min(window_end - now, self.idle_s)):
                    break  # idle gap elapsed with nothing new
            return batch, len(self.queue)


class LoopbackSolverd:
    def __init__(self, socket_path: str, idle_ms: float = 5,
                 max_ms: float = 100, max_batch: int = 64,
                 reset_state: bool = True):
        self.socket_path = socket_path
        self._window = _Window(idle_ms, max_ms, max_batch)
        self._closed = False
        self._conn_seq = 0
        self._threads = []
        self._write_locks = {}
        if reset_state:
            # a loopback start IS a logical worker start: stats must not
            # report a previous harness run's history (the same contract
            # native/solverd.cc applies on boot)
            from karpenter_tpu_torch.service import backend
            backend.reset_worker_state()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(socket_path)
        self._srv.listen(64)
        self._spawn(self._accept_loop, "loopback-accept")
        self._spawn(self._batcher_loop, "loopback-batcher")

    def _spawn(self, fn, name):
        t = threading.Thread(target=fn, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    # -- socket side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conn_seq += 1
            # bounded reads so close() unwedges reader threads promptly
            conn.settimeout(0.5)
            self._write_locks[conn] = threading.Lock()
            self._spawn(lambda c=conn, i=self._conn_seq:
                        self._reader_loop(c, i), "loopback-reader")

    def _reader_loop(self, conn, conn_id: int) -> None:
        try:
            while not self._closed:
                header = self._read_exact(conn, 12)
                if header is None:
                    return
                plen, rid = struct.unpack("<IQ", header)
                if plen > _MAX_FRAME:
                    return
                payload = self._read_exact(conn, plen)
                if payload is None:
                    return
                self._window.push((conn, conn_id, rid, payload))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _read_exact(self, conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                if self._closed:
                    return None
                continue
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- the window → backend seam ----------------------------------------
    def _batcher_loop(self) -> None:
        from karpenter_tpu_torch.service import backend
        while not self._closed:
            batch, backlog = self._window.collect()
            if not batch:
                if self._window.stopping:
                    return
                continue
            payloads = [p for _, _, _, p in batch]
            conn_ids = [cid for _, cid, _, _ in batch]
            try:
                outs = backend.handle_batch(payloads, conn_ids, backlog)
            except Exception:  # noqa: BLE001 — answer with the daemon's marker
                outs = [b"\x80\x04N."] * len(batch)
            for (conn, _cid, rid, _p), out in zip(batch, outs):
                frame = struct.pack("<IQ", len(out), rid) + out
                lock = self._write_locks.get(conn)
                try:
                    if lock is not None:
                        with lock:
                            # serializing the WRITE is the point, exactly
                            # as in send_response's write_mu
                            conn.sendall(frame)  # kt-lint: disable=lock-discipline
                    else:
                        conn.sendall(frame)
                except OSError:
                    pass  # peer died; its client reader fails its waiters

    def close(self) -> None:
        self._closed = True
        with self._window.cv:
            self._window.stopping = True
            self._window.cv.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass
        for conn in list(self._write_locks):
            try:
                conn.close()
            except OSError:
                pass
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
