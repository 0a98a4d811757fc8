"""A kube-apiserver-protocol store backend.

The third `StoreBackend`: REST list/watch JSON over chunked HTTP against
a minimal in-repo fake apiserver — the operating mode of the reference's
controllers (informers + `client.Client`,
cmd/controller/main.go:46-54) reduced to the slice this
framework's `Cluster` actually consumes.

The port's copy of `karpenter_tpu/store/http.py`, protocol, echo
suppression and relist recovery unchanged.  Like the JAX package's
server, the handler writes a response in two sends (the headers, then
the body), so each request pays the Nagle / delayed-ACK stall of the
loopback link: about 44 ms.

Protocol (kube-shaped, per resource kind):

  GET    /apis/karpenter.tpu/v1/{kind}             list
      → {"kind": "...List", "metadata": {"resourceVersion": "N"},
         "items": [item, ...]}
  GET    /apis/karpenter.tpu/v1/{kind}?watch=true&resourceVersion=N
      → Transfer-Encoding: chunked; one JSON watch event per line:
        {"type": "ADDED|MODIFIED|DELETED", "object": item}
        410 Gone when N predates the retained event log (client relists
        and resumes — the informer ListAndWatch loop).
  POST   /apis/karpenter.tpu/v1/{kind}             create (409 if exists)
  PUT    /apis/karpenter.tpu/v1/{kind}/{name}      update (404 if absent)
  DELETE /apis/karpenter.tpu/v1/{kind}/{name}      delete (404 if absent)

Items are kube-shaped JSON envelopes:

  {"apiVersion": "karpenter.tpu/v1", "kind": "<Kind>",
   "metadata": {"name": ..., "resourceVersion": "17",
                "deletionTimestamp": ...?},
   "data": "<codec payload>"}

resourceVersion is a global monotonic counter (the etcd-revision
analogue); deletion-in-progress rides metadata.deletionTimestamp exactly
as in kube (a MODIFIED event whose object carries a deletionTimestamp is
the "deleting" verb).  Write responses return the stored item — the
client uses the returned resourceVersion to suppress its own watch
echoes, the same dedup a kube informer performs by revision.

The object payload codec is a seam: `PickleCodec` (default) base64s the
in-repo model objects; a real-cluster attach swaps it for the CRD JSON
codec plus auth/TLS plumbing — the protocol layer above does not change
(docs/store-backends.md).
"""

from __future__ import annotations

import base64
import http.client
import json
import pickle
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

GROUP_PATH = "/apis/karpenter.tpu/v1"


class PickleCodec:
    """Default payload codec: model objects ↔ base64 pickle.  Safe the
    same way the solverd/store-daemon pickles are: the fake apiserver is
    a loopback listener owned by the test/operator process, not an open
    network service.  The real-cluster codec (CRD JSON) replaces this
    without touching the protocol layer."""

    def encode(self, obj: object) -> str:
        return base64.b64encode(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)).decode()

    def decode(self, data: str) -> object:
        return pickle.loads(base64.b64decode(data))


class FakeApiServer:
    """Minimal kube-protocol apiserver: list/watch/create/update/delete
    with global resourceVersions, a bounded event log, and chunked watch
    streams.  Payload-agnostic — it stores and replays item JSON without
    decoding the codec body, exactly as a real apiserver treats specs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 retain_events: int = 4096):
        self._lock = threading.Condition()
        # kind → name → item dict (with metadata.resourceVersion)
        self._data: Dict[str, Dict[str, dict]] = {}
        self._rv = 0
        # (rv, kind, type, item) — bounded; watches older than the tail
        # get 410 Gone and must relist
        self._log: List[Tuple[int, str, str, dict]] = []
        self._retain = retain_events
        self._closed = False

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _status(self, code: int, reason: str):
                self._json(code, {"kind": "Status", "code": code,
                                  "reason": reason})

            def _parts(self):
                u = urlparse(self.path)
                if not u.path.startswith(GROUP_PATH + "/"):
                    return None, None, {}
                rest = u.path[len(GROUP_PATH) + 1:].strip("/").split("/")
                kind = rest[0] if rest and rest[0] else None
                name = rest[1] if len(rest) > 1 else None
                return kind, name, parse_qs(u.query)

            def do_GET(self):
                kind, name, q = self._parts()
                if kind is None:
                    return self._status(404, "NotFound")
                if q.get("watch", ["false"])[0] in ("true", "1"):
                    return server._serve_watch(
                        self, kind,
                        int(q.get("resourceVersion", ["0"])[0]))
                # snapshot under the lock, write the response outside it —
                # a slow reader must not stall every writer behind the
                # store lock (kt-lint lock-discipline)
                items = rv = None
                with server._lock:
                    if name is not None:
                        item = server._data.get(kind, {}).get(name)
                    else:
                        items = list(server._data.get(kind, {}).values())
                        rv = server._rv
                if name is not None:
                    if item is None:
                        return self._status(404, "NotFound")
                    return self._json(200, item)
                return self._json(200, {
                    "kind": kind.capitalize() + "List",
                    "apiVersion": "karpenter.tpu/v1",
                    "metadata": {"resourceVersion": str(rv)},
                    "items": items})

            def _read_body(self) -> Optional[dict]:
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    return json.loads(self.rfile.read(n))
                except ValueError:
                    self._status(400, "BadRequest")
                    return None

            def do_POST(self):
                kind, _, _ = self._parts()
                if kind is None:
                    return self._status(404, "NotFound")
                item = self._read_body()
                if item is None:
                    return  # _read_body already answered 400
                name = item.get("metadata", {}).get("name")
                if not name:
                    return self._status(422, "Invalid")
                with server._lock:
                    if name in server._data.setdefault(kind, {}):
                        stored = None
                    else:
                        stored = server._commit(kind, name, item, "ADDED")
                if stored is None:
                    return self._status(409, "AlreadyExists")
                return self._json(201, stored)

            def do_PUT(self):
                kind, name, _ = self._parts()
                if kind is None:
                    return self._status(404, "NotFound")
                if name is None:
                    return self._status(405, "MethodNotAllowed")
                item = self._read_body()
                if item is None:
                    return  # _read_body already answered 400
                with server._lock:
                    if name not in server._data.setdefault(kind, {}):
                        # modify-of-deleted: the apiserver-404 analogue
                        stored = None
                    else:
                        stored = server._commit(kind, name, item, "MODIFIED")
                if stored is None:
                    return self._status(404, "NotFound")
                return self._json(200, stored)

            def do_DELETE(self):
                kind, name, _ = self._parts()
                if kind is None or name is None:
                    return self._status(404, "NotFound")
                with server._lock:
                    item = server._data.get(kind, {}).pop(name, None)
                    if item is not None:
                        server._rv += 1
                        tomb = dict(item)
                        tomb["metadata"] = dict(
                            item["metadata"],
                            resourceVersion=str(server._rv))
                        server._append_event(kind, "DELETED", tomb)
                if item is None:
                    return self._status(404, "NotFound")
                return self._json(200, tomb)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="kt-fake-apiserver")
        self._thread.start()

    # -- storage (lock held by callers) -----------------------------------
    def _commit(self, kind: str, name: str, item: dict,
                etype: str) -> dict:
        self._rv += 1
        stored = dict(item)
        stored["metadata"] = dict(item.get("metadata", {}),
                                  name=name,
                                  resourceVersion=str(self._rv))
        self._data[kind][name] = stored
        self._append_event(kind, etype, stored)
        return stored

    def _append_event(self, kind: str, etype: str, item: dict) -> None:
        self._log.append((self._rv, kind, etype, item))
        if len(self._log) > self._retain:
            del self._log[: len(self._log) - self._retain]
        self._lock.notify_all()

    # -- watch -------------------------------------------------------------
    def _serve_watch(self, handler, kind: str, rv: int) -> None:
        with self._lock:
            # decide under the lock, answer outside it — the 410 write
            # must not ride the store lock (kt-lint lock-discipline)
            expired = bool(self._log) and 0 < rv < self._log[0][0] - 1
        if expired:
            # the requested horizon fell off the log: 410 Gone, the
            # client relists (informer ListAndWatch recovery)
            return handler._status(410, "Expired")
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        def chunk(payload: dict) -> bool:
            line = (json.dumps(payload) + "\n").encode()
            try:
                handler.wfile.write(f"{len(line):x}\r\n".encode()
                                    + line + b"\r\n")
                handler.wfile.flush()
                return True
            except OSError:
                return False

        last = rv
        while not self._closed:
            batch = []
            with self._lock:
                if self._log and last < self._log[0][0] - 1:
                    # the stream fell behind the bounded log mid-watch:
                    # events were trimmed unseen. Close the stream — the
                    # client reconnects from its last rv, receives 410,
                    # and relists (silently skipping the gap would lose
                    # peer events forever)
                    return
                for erv, ekind, etype, item in self._log:
                    if erv > last and ekind == kind:
                        batch.append((erv, etype, item))
                if not batch:
                    self._lock.wait(timeout=0.5)
            for erv, etype, item in batch:
                if not chunk({"type": etype, "object": item}):
                    return
                last = erv

    def close(self) -> None:
        self._closed = True
        with self._lock:
            self._lock.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()


class HttpBackend:
    """`StoreBackend` over the kube list/watch protocol.

    One watcher thread per kind (started on the kind's first `load`, as
    an informer starts per-resource reflectors), merging decoded events
    into one queue.  Own-write echoes are suppressed by a client-stamped
    metadata write-id recorded BEFORE the request goes out (the watch can
    deliver the echo before the write response returns, so a
    response-derived marker would race); own deletes are suppressed by a
    pending-delete marker per (kind, name).  A 410 Gone relists and
    diffs against the last-known name set, synthesizing DELETED events
    for names that vanished inside the gap."""

    def __init__(self, base_url: str, codec: Optional[PickleCodec] = None):
        u = urlparse(base_url)
        self._host = u.hostname
        self._port = u.port or 80
        self._codec = codec or PickleCodec()
        self._lock = threading.Lock()
        self._events: List[Tuple[str, str, str, Optional[object]]] = []
        self._own_write_ids: set = set()
        self._own_order: List[str] = []
        # own-delete markers, checkout-style (the discipline of
        # RemoteBackend._call): registered under the small lock BEFORE
        # the RPC goes out, resolved after it returns — no lock is ever
        # held across the wire.  Value is the delete's resourceVersion
        # once known (0 while the RPC is in flight); _relist_after_gap
        # uses it to decide whether the DELETED echo is still ahead of
        # the relist resume horizon (keep the marker) or fell behind it
        # (drop it, or it would swallow a PEER's later delete).
        self._pending_deletes: Dict[Tuple[str, str], int] = {}
        # kind → names whose own put committed while a relist was in
        # flight for that kind; the relist diff must not synthesize a
        # delete for them (their create raced the list snapshot)
        self._relist_touched: Dict[str, set] = {}
        self._relist_rv: Dict[str, int] = {}
        self._watchers: Dict[str, threading.Thread] = {}
        self._known: Dict[str, set] = {}
        self._closed = False
        self._rpc_lock = threading.Lock()
        self._rpc_conn: Optional[http.client.HTTPConnection] = None

    # -- HTTP plumbing -----------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self._host, self._port, timeout=30)

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Tuple[int, dict]:
        # one persistent keep-alive connection for RPCs (the server is
        # HTTP/1.1): per-call connect/teardown would pay TCP setup on
        # every cluster mutation. Reconnect-once on a broken socket.
        # child_span: store I/O annotates whatever trace is in flight (a
        # provisioning pass applying claims) but never starts one of its
        # own — the watch thread's polling would flood the ring buffer
        from karpenter_tpu_torch.utils import tracing
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        with tracing.child_span("store.http.request", method=method,
                                path=path) as _sp:
            for attempt in (0, 1):
                # check the keep-alive connection out of its one-slot
                # pool and run the round trip OUTSIDE the lock: holding
                # _rpc_lock across the wire call serialized every caller
                # behind one slow response (kt-lint lock-discipline). A
                # concurrent caller finding the slot empty pays a fresh
                # connection instead of waiting.
                with self._rpc_lock:
                    conn, self._rpc_conn = self._rpc_conn, None
                if conn is None:
                    conn = self._conn()
                try:
                    conn.request(method, path, body=payload,
                                 headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()
                except (OSError, http.client.HTTPException):
                    try:
                        conn.close()
                    except OSError:
                        pass
                    if attempt:
                        raise
                    continue
                with self._rpc_lock:
                    if self._rpc_conn is None and not self._closed:
                        self._rpc_conn = conn  # back into the pool
                        conn = None
                if conn is not None:
                    conn.close()
                break
            if _sp is not None:
                _sp.attrs["status"] = resp.status
        try:
            doc = json.loads(data) if data else {}
        except ValueError:
            doc = {}
        return resp.status, doc

    def _item(self, kind: str, name: str, obj: object,
              write_id: str) -> dict:
        meta = {"name": name, "kt-write-id": write_id}
        if getattr(getattr(obj, "meta", None), "deleting", False):
            # deletion-in-progress rides metadata, as in kube
            meta["deletionTimestamp"] = "1970-01-01T00:00:00Z"
        return {"apiVersion": "karpenter.tpu/v1",
                "kind": kind.rstrip("s").capitalize(),
                "metadata": meta,
                "data": self._codec.encode(obj)}

    def _note_own(self, write_id: str) -> None:
        with self._lock:
            self._own_write_ids.add(write_id)
            self._own_order.append(write_id)
            if len(self._own_order) > 4096:
                self._own_write_ids.discard(self._own_order.pop(0))

    # -- StoreBackend ------------------------------------------------------
    def load(self, kind: str) -> Dict[str, object]:
        status, doc = self._request("GET", f"{GROUP_PATH}/{kind}")
        if status != 200:
            return {}
        out = {}
        for item in doc.get("items", []):
            name = item["metadata"]["name"]
            out[name] = self._codec.decode(item["data"])
        rv = int(doc.get("metadata", {}).get("resourceVersion", "0"))
        with self._lock:
            self._known[kind] = set(out)
            if kind not in self._watchers and not self._closed:
                t = threading.Thread(target=self._watch_loop,
                                     args=(kind, rv), daemon=True,
                                     name=f"kt-http-watch-{kind}")
                self._watchers[kind] = t
                t.start()
        return out

    def put(self, kind: str, name: str, obj: object,
            verb: str = "modified") -> bool:
        import uuid
        write_id = uuid.uuid4().hex
        # recorded BEFORE the request: the watch stream can deliver the
        # echo before the HTTP response returns
        self._note_own(write_id)
        item = self._item(kind, name, obj, write_id)
        # RPC outside any lock (checkout-style, kt-lint lock-discipline);
        # the commit below records the name in _relist_touched when a
        # 410 relist is concurrently in flight, which is what keeps the
        # relist's list-then-diff from synthesizing a spurious delete
        # for a live object whose create raced the list snapshot
        if verb == "added":
            status, doc = self._request(
                "POST", f"{GROUP_PATH}/{kind}", item)
            if status == 409:
                return False
        else:
            status, doc = self._request(
                "PUT", f"{GROUP_PATH}/{kind}/{name}", item)
            if status == 404:
                return False
        if status in (200, 201):
            with self._lock:
                self._known.setdefault(kind, set()).add(name)
                touched = self._relist_touched.get(kind)
                if touched is not None:
                    touched.add(name)
            return True
        return False

    def delete(self, kind: str, name: str) -> None:
        with self._lock:
            # a marker is only consumable when a watcher is running
            # for the kind; otherwise it would linger and swallow a
            # PEER's later delete of the same name.  0 = RPC in flight.
            marked = kind in self._watchers
            if marked:
                self._pending_deletes[(kind, name)] = 0
        try:
            status, doc = self._request(
                "DELETE", f"{GROUP_PATH}/{kind}/{name}")
        except Exception:
            with self._lock:
                # a marker for a write that never happened would
                # swallow a peer's later delete of the same name
                self._pending_deletes.pop((kind, name), None)
            raise
        with self._lock:
            if status == 200:
                self._known.get(kind, set()).discard(name)
                rv = int(doc.get("metadata", {})
                         .get("resourceVersion", "0") or 0)
                if marked and (kind, name) in self._pending_deletes:
                    if rv and rv <= self._relist_rv.get(kind, 0):
                        # a relist overtook this delete: the DELETED
                        # echo predates the resume horizon, so the
                        # watcher will never consume the marker
                        self._pending_deletes.pop((kind, name), None)
                    else:
                        self._pending_deletes[(kind, name)] = rv
            else:
                self._pending_deletes.pop((kind, name), None)

    def events(self) -> List[Tuple[str, str, str, Optional[object]]]:
        with self._lock:
            out = self._events
            self._events = []
        return out

    def close(self) -> None:
        self._closed = True
        with self._rpc_lock:
            if self._rpc_conn is not None:
                try:
                    self._rpc_conn.close()
                except OSError:
                    pass
                self._rpc_conn = None

    # -- watch loop --------------------------------------------------------
    def _emit(self, kind: str, verb: str, name: str,
              obj: Optional[object]) -> None:
        with self._lock:
            self._events.append((kind, verb, name, obj))
            known = self._known.setdefault(kind, set())
            if verb == "deleted":
                known.discard(name)
            else:
                known.add(name)

    def _watch_loop(self, kind: str, rv: int) -> None:
        import time
        while not self._closed:
            try:
                conn = self._conn()
                conn.request(
                    "GET",
                    f"{GROUP_PATH}/{kind}?watch=true&resourceVersion={rv}")
                resp = conn.getresponse()
                if resp.status == 410:
                    conn.close()
                    rv = self._relist_after_gap(kind)
                    continue
                if resp.status != 200:
                    # transient server trouble (5xx against a real
                    # apiserver is routine): back off and re-establish —
                    # a dead watcher would silently lose every future
                    # peer event for this kind
                    conn.close()
                    time.sleep(0.2)
                    continue
                while not self._closed:
                    line = resp.readline()
                    if not line:
                        break  # stream closed; reconnect from last rv
                    event = json.loads(line)
                    if event.get("type") == "ERROR":
                        break  # kube error Status object: reconnect
                    item = event["object"]
                    rv = int(item["metadata"]["resourceVersion"])
                    name = item["metadata"]["name"]
                    wid = item["metadata"].get("kt-write-id")
                    with self._lock:
                        own = wid is not None and wid in self._own_write_ids
                    if own and event["type"] != "DELETED":
                        continue
                    if event["type"] == "DELETED":
                        with self._lock:
                            if (kind, name) in self._pending_deletes:
                                self._pending_deletes.pop((kind, name))
                                continue
                        self._emit(kind, "deleted", name, None)
                        continue
                    obj = self._codec.decode(item["data"])
                    if event["type"] == "ADDED":
                        verb = "added"
                    elif item["metadata"].get("deletionTimestamp"):
                        verb = "deleting"
                    else:
                        verb = "modified"
                    self._emit(kind, verb, name, obj)
                conn.close()
            except Exception:  # noqa: BLE001 — the watcher must survive
                # anything (parse error on a truncated line, refused
                # connection, codec hiccup); it reconnects from the last
                # good rv rather than dying unrestartably
                if self._closed:
                    return
                time.sleep(0.05)

    def _relist_after_gap(self, kind: str) -> int:
        """410 Gone: the watch horizon fell off the server's event log.
        Relist, diff against last-known names (synthesizing deletes for
        names that vanished inside the gap), and resume from the list's
        resourceVersion — informer ListAndWatch recovery.

        Checkout-style against concurrent own writes (no lock is held
        across the list RPC): a _relist_touched window is opened under
        the small lock before the GET goes out, own puts that commit
        inside the window record their name there, and the diff skips
        those names — a create racing the list snapshot must not be
        synthesized into a delete (its ADDED echo would then be
        swallowed by write-id suppression, losing the object for good).
        Own-delete markers are reconciled by resourceVersion: a marker
        whose DELETED echo predates the list's resourceVersion (the
        resume horizon) is dropped — the watcher will never consume it,
        and a lingering marker would swallow a peer's later delete —
        while markers still in flight or ahead of the horizon are kept,
        and their names are excluded from the diff so an own delete is
        never double-reported through gap recovery."""
        with self._lock:
            # open the touched window before the list RPC is issued
            self._relist_touched[kind] = set()
        status, doc = self._request("GET", f"{GROUP_PATH}/{kind}")
        if status != 200:
            with self._lock:
                self._relist_touched.pop(kind, None)
            return 0
        list_rv = int(doc.get("metadata", {}).get("resourceVersion", "0"))
        now = {}
        for item in doc.get("items", []):
            now[item["metadata"]["name"]] = item
        with self._lock:
            before = set(self._known.get(kind, set()))
            touched = self._relist_touched.pop(kind, set())
            own_deleting = set()
            kept: Dict[Tuple[str, str], int] = {}
            for (k, n), drv in self._pending_deletes.items():
                if k != kind:
                    kept[(k, n)] = drv
                    continue
                own_deleting.add(n)
                if drv == 0 or drv > list_rv:
                    # RPC still in flight, or the DELETED echo is ahead
                    # of the resume horizon: the watcher will consume it
                    kept[(k, n)] = drv
                # else: the echo fell behind the horizon — unconsumable
            self._pending_deletes = kept
            self._relist_rv[kind] = list_rv
        for name in sorted(before - set(now)):
            if name in touched or name in own_deleting:
                continue
            self._emit(kind, "deleted", name, None)
        for name, item in now.items():
            if name in own_deleting:
                continue  # mid-own-delete: the snapshot is already stale
            wid = item["metadata"].get("kt-write-id")
            with self._lock:
                if wid is not None and wid in self._own_write_ids:
                    continue  # our own write: the cache is current
            obj = self._codec.decode(item["data"])
            verb = ("deleting"
                    if item["metadata"].get("deletionTimestamp")
                    else "modified")
            self._emit(kind, verb, name, obj)
        return list_rv
