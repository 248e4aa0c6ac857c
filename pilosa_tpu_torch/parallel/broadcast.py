"""Queued, retried async cluster-message broadcast, after the JAX
package's ``parallel/broadcast.py``.

Reference: broadcast.go:30 SendAsync rides memberlist's
TransmitLimitedQueue (gossip/gossip.go:306-318) — a message to a
briefly-down node is retransmitted by the gossip layer rather than
lost. The rebuild's control plane is direct HTTP, so the equivalent is
explicit: per-peer FIFO queues drained by one worker thread; a failed
send backs that peer off (exponential, capped) and retries in order
until the message's TTL expires. Ordering per peer is preserved —
queued messages to a down peer never overtake each other — while a
down peer never blocks delivery to healthy ones.

Schema mutations stay on the synchronous broadcast path (the
reference's SendSync, server.go:582): their callers need create/delete
to be visible cluster-wide on return. This queue carries the
membership/cache messages where best-effort-with-retry is the point
(node-join/leave, resize-complete, shards-changed, translate pin).
"""

from __future__ import annotations

import threading
from pilosa_tpu_torch.utils.locks import make_lock
import time
from collections import deque
from typing import Dict, Optional

from pilosa_tpu_torch.parallel.client import InternalClient


class AsyncBroadcaster:
    RETRY_BASE_S = 1.0    # first retry delay after a failure
    RETRY_MAX_S = 15.0    # backoff cap

    def __init__(self, client: Optional[InternalClient] = None,
                 logger=None, ttl: float = 300.0):
        self._client = client or InternalClient(timeout=10.0)
        self._logger = logger
        self.ttl = ttl
        # peer uri -> deque of (deadline_unix, message dict)
        self._queues: Dict[str, deque] = {}
        # peer uri -> (next_attempt_unix, current_backoff_s)
        self._backoff: Dict[str, tuple] = {}
        self._lock = make_lock("AsyncBroadcaster._lock")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()  # set while every queue is empty
        self._idle.set()
        self.sent = 0      # delivered messages (observability/tests)
        self.expired = 0   # dropped past TTL
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="async-broadcast")
        self._thread.start()

    def _log(self, fmt, *args):
        if self._logger is not None:
            self._logger.printf(fmt, *args)

    def send(self, uri: str, message: dict,
             coalesce: bool = False) -> None:
        """Queue `message` for `uri`; returns immediately. Delivery is
        at-least-once within the TTL (receivers are idempotent — the
        same property the reference's gossip retransmit relies on).
        coalesce=True skips the enqueue when an identical message is
        already pending for this peer (pure cache-invalidation messages
        like shards-changed: N queued copies do what one does)."""
        with self._lock:
            q = self._queues.setdefault(uri, deque())
            if coalesce and any(m == message for _, m in q):
                return
            q.append((time.time() + self.ttl, message))
            self._idle.clear()
        self._wake.set()

    def has_pending(self, uri: str) -> bool:
        with self._lock:
            return bool(self._queues.get(uri))

    def send_now_or_queue(self, uri: str, message: dict,
                          coalesce: bool = False) -> bool:
        """Deliver synchronously when possible, queue otherwise —
        WITHOUT breaking per-peer ordering: if messages are already
        queued for this peer, this one lines up behind them (a sync
        send would overtake the queue and e.g. land resize-complete
        before the node-leave it completes). Topology-change callers
        use this so reachable peers learn the new membership BEFORE any
        follow-up direct RPC (the resize job's pull) reaches them, and
        cache-invalidation callers so an import ack means reachable
        peers already dropped their caches. Returns True when
        delivered now."""
        if not self.has_pending(uri):
            try:
                self._client.cluster_message(uri, message)
                with self._lock:
                    self.sent += 1
                return True
            except Exception:
                pass  # fall through to the queued/retried path
        self.send(uri, message, coalesce=coalesce)
        return False

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every queue is empty (tests); False on timeout."""
        return self._idle.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                pending = any(self._queues.values())
            # Timed wake only while retries are owed; fully idle blocks.
            self._wake.wait(timeout=0.5 if pending else None)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                now = time.time()
                with self._lock:
                    peers = [u for u, q in self._queues.items() if q]
                for uri in peers:
                    if self._stop.is_set():
                        return
                    with self._lock:
                        nxt, backoff = self._backoff.get(uri, (0.0, 0.0))
                    # the backoff gate is
                    # advisory: a racing re-arm at worst drains one
                    # poll tick early, and _drain_peer re-reads the
                    # queue under the lock before every send.
                    if now < nxt:
                        continue
                    # backoff is a retry
                    # hint, not state: _drain_peer resets it from the
                    # send outcome, re-checking the head under the
                    # lock before each pop.
                    self._drain_peer(uri, backoff)
                with self._lock:
                    if not any(self._queues.values()):
                        self._idle.set()
            except Exception as e:  # the worker must never die
                self._log("async-broadcast: worker error %r; continuing",
                          e)
                time.sleep(0.5)

    def _drain_peer(self, uri: str, backoff: float) -> None:
        """Send this peer's queue head-first until it empties or a send
        fails (which re-arms the peer's backoff)."""
        while not self._stop.is_set():
            with self._lock:
                q = self._queues.get(uri)
                if not q:
                    if q is not None:
                        # Drained empty: drop the peer's dict entry, so
                        # departed nodes don't leave a key behind for
                        # the life of the process (send() re-creates it
                        # on the next message).
                        del self._queues[uri]
                    return
                deadline, msg = q[0]
            if time.time() > deadline:
                with self._lock:
                    if q and q[0] == (deadline, msg):
                        q.popleft()
                self.expired += 1
                self._log("async-broadcast: message %r to %s expired "
                          "after %.0fs of retries", msg.get("type"), uri,
                          self.ttl)
                continue
            try:
                self._client.cluster_message(uri, msg)
            except Exception as e:
                # Broad on purpose: ANY delivery failure (transport, a
                # malformed 200 body raising in the codec, ...) must
                # back off and retry — an escaping exception would kill
                # the single worker thread and silently halt all async
                # control-plane delivery.
                nxt_backoff = min(self.RETRY_MAX_S,
                                  (backoff * 2) or self.RETRY_BASE_S)
                with self._lock:
                    self._backoff[uri] = (time.time() + nxt_backoff,
                                          nxt_backoff)
                self._log("async-broadcast: %s delivery failed (%s); "
                          "retrying in %.1fs", uri, e, nxt_backoff)
                return
            with self._lock:
                if q and q[0] == (deadline, msg):
                    q.popleft()
                self._backoff.pop(uri, None)
                self.sent += 1  # under the lock: callers also bump it
            backoff = 0.0
