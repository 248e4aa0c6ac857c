"""Failure detection and standing translate replication, after the JAX
package's ``parallel/heartbeat.py``.

Reference: membership liveness comes from hashicorp/memberlist SWIM
gossip (reference gossip/gossip.go:43,246): probes mark nodes
dead, the cluster goes DEGRADED, and queries avoid dead members.
With a single-controller deployment a full SWIM protocol is
unnecessary; a direct heartbeat prober gives the same observable
behavior — peers marked down after N consecutive probe failures,
DEGRADED status, proactive query failover — without the gossip fabric
(divergence documented in parallel/cluster.py).

Translate replication: the reference runs a standing loop per replica
streaming the primary's translate log (monitorReplication/replicate,
reference translate.go:359-400). TranslateReplicationLoop is that
loop: incremental log pulls from the primary on an interval, so replicas
converge without waiting for anti-entropy or a read-path fallback.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from pilosa_tpu_torch.parallel.client import ClientError, InternalClient
from pilosa_tpu_torch.parallel.cluster import Cluster
from pilosa_tpu_torch.utils.failpoints import (
    FAILPOINTS, FailpointDrop, FailpointError,
)

# One heartbeat probe about to be sent: `error`/`partition` count as a
# failed probe (drives mark_down after suspect_after rounds), `drop`
# silently loses the probe (no failure, no success — a lossy network),
# `delay` slows the prober. The receive side is the `api.status` site:
# arming error THERE makes a node look dead to every prober.
_FP_HB_PROBE = FAILPOINTS.register("heartbeat.probe")


class Heartbeater:
    """Rotating-subset failure detector: each round probes at most
    `probes_per_round` healthy peers from a shuffled ring (O(N) probe
    load cluster-wide, like SWIM's one-peer-per-round — the reference's
    memberlist config, gossip/gossip.go:246 — where an all-peers mesh
    would be O(N^2)), PLUS every currently-suspect peer (so detection
    still takes `suspect_after` consecutive rounds, not a full ring
    rotation) and one known-down peer (so recovery is noticed within a
    round). After `suspect_after` consecutive failures a peer is marked
    down (cluster DEGRADED, routing prefers live replicas); one
    successful probe marks it back up."""

    def __init__(self, cluster: Cluster, interval: float = 2.0,
                 suspect_after: int = 3, timeout: Optional[float] = None,
                 logger=None, probes_per_round: int = 2,
                 ssl_context=None):
        self.cluster = cluster
        self.interval = interval
        self.suspect_after = suspect_after
        self.probes_per_round = probes_per_round
        # Short probe timeout: a hung peer must not stall the prober.
        self.client = InternalClient(timeout=timeout or max(interval, 1.0),
                                     ssl_context=ssl_context)
        self.logger = logger
        self._fails: Dict[str, int] = {}
        self._ring: List[str] = []
        self._ring_pos = 0
        self._down_pos = 0
        self.last_round_probes = 0  # observability / tests
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _log(self, fmt, *args):
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def _round_targets(self, peers):
        """Suspects + one rotating down peer + ring rotation filling up
        to probes_per_round."""
        by_id = {n.id: n for n in peers}
        if set(self._ring) != set(by_id):
            self._ring = list(by_id)
            random.shuffle(self._ring)
            self._ring_pos = 0
        down_ids = sorted(self.cluster.down_ids & set(by_id))
        targets: Dict[str, object] = {
            nid: by_id[nid] for nid in self._fails
            if nid in by_id and nid not in self.cluster.down_ids}
        if down_ids:
            pick = down_ids[self._down_pos % len(down_ids)]
            self._down_pos += 1
            targets.setdefault(pick, by_id[pick])
        budget = min(self.probes_per_round, len(peers))
        for _ in range(len(self._ring)):
            if len(targets) >= budget:
                break
            nid = self._ring[self._ring_pos % len(self._ring)]
            self._ring_pos += 1
            if nid in self.cluster.down_ids:
                continue  # down peers probe via the rotating slot above
            targets.setdefault(nid, by_id[nid])
        return list(targets.values())

    def probe_once(self) -> None:
        """One probe round (tests call this directly)."""
        peers = [n for n in self.cluster.nodes()
                 if n.id != self.cluster.local.id]
        if not peers:
            self.last_round_probes = 0
            return
        targets = self._round_targets(peers)
        self.last_round_probes = len(targets)
        for node in targets:
            try:
                try:
                    _FP_HB_PROBE.fire(uri=node.uri)
                except FailpointDrop:
                    continue  # probe lost in flight: no verdict either way
                self.client.status(node.uri)
            except (ClientError, FailpointError):
                n = self._fails.get(node.id, 0) + 1
                self._fails[node.id] = n
                if n >= self.suspect_after and \
                        self.cluster.mark_down(node.id):
                    self._log("heartbeat: node %s DOWN after %d failed "
                              "probes; cluster %s", node.id, n,
                              self.cluster.state)
            else:
                self._fails.pop(node.id, None)
                if self.cluster.mark_up(node.id):
                    self._log("heartbeat: node %s recovered; cluster %s",
                              node.id, self.cluster.state)

    def start(self) -> None:
        if self.interval <= 0:
            return

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.probe_once()
                except Exception as e:  # keep the detector alive
                    self._log("heartbeat round failed: %s: %s",
                              type(e).__name__, e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class TranslateReplicationLoop:
    """Standing replica-side loop pulling the primary's translate logs
    incrementally (reference replicate loop, translate.go:359-400; here
    pull-based from byte offsets instead of a held-open stream)."""

    def __init__(self, api, interval: float = 10.0):
        self.api = api
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def replicate_once(self) -> None:
        self.api._sync_translate_stores()

    def start(self) -> None:
        if self.interval <= 0:
            return

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.replicate_once()
                except Exception as e:
                    self.api.logger.printf(
                        "translate replication pass failed: %s: %s",
                        type(e).__name__, e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
