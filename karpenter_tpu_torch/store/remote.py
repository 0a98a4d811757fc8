"""Process-external store backend over a unix socket.

The port's copy of `karpenter_tpu/store/remote.py`: the same wire
format, conflict rules, echo suppression and socket deadlines.  The
daemon holds pickles of the port's model objects, none of which carries
a tensor, so the daemon process needs no device.

The solverd pattern (native/solverd.cc: one daemon, length-prefixed
frames, many clients) applied to cluster state: `StoreDaemon` holds the
authoritative pickled copies and fans mutation events out to every
watcher; `RemoteBackend` is the client — it forwards writes, drains peer
events, and hydrates relists. Two operator replicas pointed at one
daemon see one cluster, which is the 2-replica active/passive layout the
reference deploys (charts/karpenter/values.yaml:35) reduced to this
environment.

Wire format: 4-byte big-endian length + pickle. Messages are dicts:
  {op: "hello", client: id}                      → {ok}
  {op: "list", kind, rid}                        → {items: {name: bytes}, rid}
  {op: "put", kind, name, data, verb, rid}       → {ok, rid}
  {op: "delete", kind, name, rid}                → {ok, rid}
  {op: "watch", client: id}                      → {ok} registration ack,
      then a stream of {op: "event", kind, verb, name, data|None, origin}

RPCs carry a client-assigned request id the daemon echoes (`rid`), so a
response can be paired with — and verified against — its request
without holding the RPC lock across the round trip.  The watch registration is ACKED under the daemon's
watcher lock: once the constructor returns, every subsequent peer write
is guaranteed to reach this backend's event buffer — the
registration-vs-first-write race.

Pickle is safe here the same way it is for solverd: the socket is a
file-permission-guarded unix socket owned by the operator deployment,
not a network listener.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.utils import faults

_LEN = struct.Struct(">I")

# RemoteBackend: idle RPC connections kept for reuse (per backend)
_IDLE_POOL_CAP = 4


def _send(sock: socket.socket, msg: dict) -> None:
    data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return pickle.loads(buf)


class StoreDaemon:
    """Authoritative store: kind → name → pickled object."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, bytes]] = {}
        self._watchers: List[Tuple[str, socket.socket]] = []
        if os.path.exists(path):
            os.unlink(path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(16)
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="store-daemon")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        client = "?"

        def reply(payload: dict) -> None:
            # echo the client's request id so the response pairs with
            # (and is verified against) exactly one request
            rid = msg.get("rid")
            _send(conn, dict(payload, rid=rid) if rid is not None
                  else payload)

        try:
            while True:
                msg = _recv(conn)
                if msg is None:
                    return
                op = msg.get("op")
                if op == "hello":
                    client = msg.get("client", "?")
                    reply({"ok": True})
                elif op == "list":
                    with self._lock:
                        items = dict(self._data.get(msg["kind"], {}))
                    reply({"items": items})
                elif op == "put":
                    verb = msg.get("verb", "modified")
                    with self._lock:
                        kind_map = self._data.setdefault(msg["kind"], {})
                        if verb != "added" and msg["name"] not in kind_map:
                            # modify/deleting against a name the store no
                            # longer holds: a peer deleted it first. A bare
                            # upsert would RESURRECT the object cluster-wide
                            # (kube-apiserver rejects this with a conflict);
                            # the writer's cache converges on its next sync.
                            conflict = True
                        elif verb == "added" and msg["name"] in kind_map:
                            # create of a name a peer already created (the
                            # failover dual-writer window with colliding
                            # generated names): last-write-wins would
                            # silently destroy the peer's object and leak
                            # whatever cloud resource it tracked — reject,
                            # like an apiserver 409; the writer rolls back
                            # its cache and retries under a fresh name.
                            conflict = True
                        else:
                            conflict = False
                            kind_map[msg["name"]] = msg["data"]
                    if conflict:
                        reply({"ok": False, "conflict": True})
                    else:
                        self._broadcast(msg.get("origin", client), {
                            "op": "event", "kind": msg["kind"],
                            "verb": verb,
                            "name": msg["name"], "data": msg["data"]})
                        reply({"ok": True})
                elif op == "delete":
                    with self._lock:
                        self._data.get(msg["kind"], {}).pop(msg["name"], None)
                    self._broadcast(msg.get("origin", client), {
                        "op": "event", "kind": msg["kind"], "verb": "deleted",
                        "name": msg["name"], "data": None})
                    reply({"ok": True})
                elif op == "watch":
                    with self._lock:
                        self._watchers.append((msg.get("client", client),
                                               conn))
                        # ack UNDER the watcher lock: a concurrent
                        # broadcast either snapshotted before the append
                        # (event not for us) or blocks on the lock until
                        # the ack is on the wire — so registration is
                        # strictly ordered before every event this
                        # watcher will ever receive, and a constructor
                        # that saw the ack can never miss a peer write
                        _send(conn, {"ok": True})  # kt-lint: disable=lock-discipline
                    return  # connection now belongs to the broadcast side
                else:
                    reply({"error": f"unknown op {op!r}"})
        except OSError:
            return

    def _broadcast(self, origin: str, event: dict) -> None:
        event = dict(event, origin=origin)
        with self._lock:
            watchers = list(self._watchers)
        dead = []
        for client, sock in watchers:
            if client == origin:
                continue  # echo suppression: the writer's cache is newer
            try:
                _send(sock, event)
            except OSError:
                dead.append((client, sock))
        if dead:
            with self._lock:
                self._watchers = [w for w in self._watchers if w not in dead]

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        # tear down the watch streams too: a watcher blocked in recv
        # must see EOF and mark its stream dead, or every replica's
        # wait_events() sleeps out its timeout against a daemon that
        # will never broadcast again
        with self._lock:
            watchers, self._watchers = list(self._watchers), []
        for _client, sock in watchers:
            try:
                sock.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class RemoteBackend:
    """Client half: synchronous RPCs over one connection, a watch stream
    on a second, peer events buffered for the cluster to drain on its
    reconcile cadence (informer semantics: level-driven, resync-safe)."""

    def __init__(self, path: str, timeout: float = 30.0):
        self.client_id = uuid.uuid4().hex
        self._path = path
        self._timeout = timeout
        self._closed = False
        self._rpc_lock = threading.Lock()
        self._rid = 0
        # small idle-connection pool (bounded): overlapping _call()s
        # each check out (or mint) their own socket, and up to
        # _IDLE_POOL_CAP come back for reuse — one slot would pay a
        # connect+hello handshake per overlapping RPC
        self._idle: List[socket.socket] = [self._rpc_connect()]
        self._watch_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._watch_sock.settimeout(timeout)
        self._watch_sock.connect(self._path)
        _send(self._watch_sock, {"op": "watch", "client": self.client_id})
        # registration ack (bounded by the connect timeout): once this
        # returns, the daemon has the watcher registered, so no peer
        # write after this constructor can be missed
        ack = _recv(self._watch_sock)
        if not (isinstance(ack, dict) and ack.get("ok")):
            self._watch_sock.close()
            raise ConnectionError(
                f"store daemon rejected watch registration: {ack!r}")
        # the watch STREAM blocks indefinitely by design: events arrive
        # whenever peers write, and close() unblocks the reader — an idle
        # timeout here would tear down a healthy quiet stream
        self._watch_sock.settimeout(None)  # kt-lint: disable=socket-discipline
        self._events: List[Tuple[str, str, str, Optional[object]]] = []
        self._events_cv = threading.Condition()
        self._watch_dead = False
        self._reader = threading.Thread(target=self._watch_loop, daemon=True,
                                        name="store-watch")
        self._reader.start()

    def _watch_loop(self) -> None:
        try:
            while not self._closed:
                try:
                    msg = _recv(self._watch_sock)
                except OSError:
                    return
                if msg is None:
                    return
                obj = (pickle.loads(msg["data"])
                       if msg.get("data") is not None else None)
                with self._events_cv:
                    self._events.append(
                        (msg["kind"], msg["verb"], msg["name"], obj))
                    self._events_cv.notify_all()
        finally:
            # stream death must wake wait_events() callers — and the
            # flag (not just the notify) is what makes a LATER waiter
            # fail fast instead of sleeping out its timeout against a
            # stream that will never deliver
            with self._events_cv:
                self._watch_dead = True
                self._events_cv.notify_all()

    def _rpc_connect(self) -> socket.socket:
        # every RPC is bounded: a wedged store daemon demotes this
        # replica (the caller sees the error and retries/records)
        # instead of freezing its reconcile loop forever behind one recv
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self._timeout)
        try:
            s.connect(self._path)
            _send(s, {"op": "hello", "client": self.client_id})
            _recv(s)
        except OSError:
            s.close()
            raise
        return s

    def _call(self, msg: dict) -> dict:
        """One bounded RPC round trip.  The cached connection is CHECKED
        OUT under `_rpc_lock` (set to None while in use) and the wire
        I/O runs outside the lock — each in-flight call owns a private
        socket, so request/response pairing holds per-socket and a
        wedged daemon stalls only the caller, never every thread queued
        behind the lock.  The daemon echoes the request id; a mismatched
        echo means the connection desynchronized (a stale response from
        a timed-out predecessor) and the connection dies with it."""
        try:
            faults.fire("store.remote.rpc")
        except faults.FaultInjected as e:
            # translate to the store's native failure type so callers'
            # existing outage handling (retry next pass, record event)
            # is what the fault exercises
            raise ConnectionError(str(e)) from e
        with self._rpc_lock:
            sock = self._idle.pop() if self._idle else None
            self._rid += 1
            rid = self._rid
        try:
            if sock is None:
                sock = self._rpc_connect()
            _send(sock, dict(msg, origin=self.client_id, rid=rid))
            out = _recv(sock)
        except OSError as e:
            # includes a failed RECONNECT: callers' outage handling is
            # keyed on ConnectionError, never raw OSError subtypes.  A
            # timeout or partial read leaves response bytes in flight —
            # the connection dies with the failure; the next _call
            # reconnects fresh.
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            raise ConnectionError(f"store rpc failed: {e}") from e
        if out is None:
            sock.close()
            raise ConnectionError("store daemon closed the connection")
        if out.get("rid") != rid:
            sock.close()
            raise ConnectionError(
                f"store rpc desynchronized (sent rid {rid}, got "
                f"{out.get('rid')!r}) — dropping the connection")
        # return the connection to the idle pool (bounded; extras close)
        with self._rpc_lock:
            if not self._closed and len(self._idle) < _IDLE_POOL_CAP:
                self._idle.append(sock)
                sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        return out

    # -- StoreBackend interface -------------------------------------------
    def load(self, kind: str) -> Dict[str, object]:
        items = self._call({"op": "list", "kind": kind})["items"]
        return {name: pickle.loads(data) for name, data in items.items()}

    def put(self, kind: str, name: str, obj: object,
            verb: str = "modified") -> bool:
        # False = the daemon rejected the write as a conflict (create of
        # an existing name, modify of a peer-deleted one). Modify
        # conflicts are absorbable (the watch stream delivers the delete
        # and the cache converges); CREATE conflicts must bubble so the
        # writer can roll back its cache and pick a fresh name.
        out = self._call({"op": "put", "kind": kind, "name": name,
                          "verb": verb,
                          "data": pickle.dumps(
                              obj, protocol=pickle.HIGHEST_PROTOCOL)})
        return bool(out.get("ok", True))

    def delete(self, kind: str, name: str) -> None:
        self._call({"op": "delete", "kind": kind, "name": name})

    def events(self) -> List[Tuple[str, str, str, Optional[object]]]:
        with self._events_cv:
            out = self._events
            self._events = []
        return out

    def wait_events(self, count: int = 1, timeout: float = 5.0) -> bool:
        """Block until at least `count` events are buffered (without
        draining them) or `timeout` elapses.  Event-DRIVEN waiting for
        tests and consumers that would otherwise poll events() in a
        sleep loop; returns False on timeout or a dead watch stream."""
        import time
        deadline = time.monotonic() + timeout
        with self._events_cv:
            while len(self._events) < count:
                left = deadline - time.monotonic()
                if left <= 0 or self._closed or self._watch_dead:
                    return len(self._events) >= count
                self._events_cv.wait(left)
            return True

    def close(self) -> None:
        self._closed = True
        with self._rpc_lock:
            idle, self._idle = list(self._idle), []
        for s in idle + [self._watch_sock]:
            try:
                s.close()
            except OSError:
                pass
