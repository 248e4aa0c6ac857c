"""Cluster topology and state, after the JAX package's
``parallel/cluster.py``: the node set sorted by id, hashed shard
placement (``hashing.py``), the states STARTING/DEGRADED/NORMAL/RESIZING,
the failure detector's down set, the pinned translate primary, a
bounded ring of lifecycle events and the ``.topology`` file.

The resize lifecycle (``begin_resize``/``end_resize``, the pre-change
placement pinned for reads) is kept as data model; the job that moves
fragments is not ported yet. A holder kept in memory has no
``.topology``: ``topology_path`` None (or "") makes ``save``/``load``
do nothing.

Reference: cluster.go:172 (cluster struct), states (:44-48),
`.topology` persistence (:1611-1646), coordinator-driven joins
(:1017-1148).

Divergences, by design:
- Membership is a static peer list + explicit join/remove calls over HTTP
  (no SWIM gossip): the single-controller deployment model makes an
  eventually-consistent membership protocol unnecessary; failure detection
  happens at request time with replica failover (the reference does that
  part the same way, executor.go:2313-2324).
- Resize is pull-based: after a topology change every node fetches the
  fragments it now owns from any current holder (reference pushes
  ResizeInstructions from the coordinator, cluster.go:1251-1360 — same
  data motion, simpler control flow).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pilosa_tpu_torch.utils.locks import make_rlock
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pilosa_tpu_torch.parallel.hashing import (
    DEFAULT_PARTITION_N, shard_nodes,
)

STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"


@dataclass
class Node:
    id: str
    uri: str  # http://host:port
    is_coordinator: bool = False

    def to_json(self) -> dict:
        return {"id": self.id, "uri": self.uri,
                "isCoordinator": self.is_coordinator}

    @classmethod
    def from_json(cls, d: dict) -> "Node":
        return cls(d["id"], d["uri"], d.get("isCoordinator", False))


class Cluster:
    """Node set sorted by id (reference cluster.go:589) with hashed shard
    placement and replica failover bookkeeping."""

    def __init__(self, local: Node, replica_n: int = 1,
                 partition_n: int = DEFAULT_PARTITION_N,
                 topology_path: Optional[str] = None):
        self.local = local
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.topology_path = topology_path
        self.state = STATE_STARTING
        self._nodes: Dict[str, Node] = {local.id: local}
        # While RESIZING, reads route against this pre-change snapshot of
        # the node list — the nodes that actually hold the data — until the
        # resize job reports completion (the safety the reference gets from
        # rejecting queries in state RESIZING, api.go:76-99; here the query
        # path stays available instead).
        self.prev_nodes: Optional[List[Node]] = None
        # Members the failure detector currently believes are dead
        # (reference: memberlist SWIM drives node state, gossip/gossip.go;
        # DEGRADED when members are missing, cluster.go:522-533). Routing
        # prefers up replicas, so a down node costs zero request timeouts.
        self.down_ids: set = set()
        # Bumped on every begin_resize: an in-flight resize job refuses to
        # finalize if a newer topology change superseded it (overlapping
        # joins must not adopt the new placement until the LAST job's
        # pulls complete).
        self.resize_gen = 0
        # Monotone placement generation: bumped on every membership or
        # placement adoption (add/remove node, resize completion). The
        # serving layer keys cache invalidation on it — a result/rank
        # cache entry filled under one placement must not survive into
        # the next unexamined (the fragments' epoch guard, applied to
        # topology).
        self.placement_gen = 0
        # Bounded cluster lifecycle event ring: membership changes,
        # failure-detector verdicts, resize begin/complete. Served in
        # /internal/health (clusterEvents), merged fleet-wide at
        # GET /cluster/timeline, so a chaos kill/recovery is visible in
        # the same planes an operator already watches.
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=256)
        # Pinned key-translation primary. None = lexically-first member
        # (single-node / static bootstrap). Pinned before the first
        # dynamic membership change so a joiner with a smaller id cannot
        # steal primacy with an EMPTY key store and mint colliding ids
        # (the reference pins the translate source by ring position,
        # cluster.go:1908-1935).
        self.translate_primary_id: Optional[str] = None
        self._lock = make_rlock("Cluster._lock")

    def translate_primary(self) -> Node:
        with self._lock:
            if self.translate_primary_id is not None:
                n = self._nodes.get(self.translate_primary_id)
                if n is not None:
                    return n
            return self._nodes[sorted(self._nodes)[0]]

    def previous_node(self) -> Optional[Node]:
        """The node listed before the local node in id order, wrapping
        (reference unprotectedPreviousNode, cluster.go:1919-1935); None
        in a single-node cluster. This is each replica's translate-log
        streaming source: chaining from ring predecessors bounds the
        primary's replication egress to ONE stream however large the
        cluster (reference setPrimaryTranslateStore at
        cluster.go:1908-1910)."""
        with self._lock:
            ids = sorted(self._nodes)
            if len(ids) <= 1 or self.local.id not in self._nodes:
                return None
            pos = ids.index(self.local.id)
            return self._nodes[ids[pos - 1]]  # -1 wraps to the last

    def pin_translate_primary(self, node_id: Optional[str] = None) -> str:
        """Pin (or re-pin) the translation primary; defaults to the
        current effective primary. Returns the pinned id."""
        with self._lock:
            if node_id is None:
                node_id = self.translate_primary().id
            self.translate_primary_id = node_id
            self.save()
            return node_id

    # -- membership ---------------------------------------------------------

    def nodes(self) -> List[Node]:
        with self._lock:
            return [self._nodes[k] for k in sorted(self._nodes)]

    def known_nodes(self) -> List[Node]:
        """Current members ∪ pre-resize members, sorted by id — every node
        that may still hold or serve data mid-resize (pull sources, shard
        discovery, write fan-out all use this union)."""
        with self._lock:
            out = dict(self._nodes)
            for n in (self.prev_nodes or []):
                out.setdefault(n.id, n)
            return [out[k] for k in sorted(out)]

    def member_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    # -- lifecycle events ----------------------------------------------------

    def _note_event(self, typ: str, node_id: Optional[str] = None,
                    **detail: Any) -> None:
        """Record one lifecycle event (lock held by callers). Ring-
        bounded; pure host dict work."""
        ev: Dict[str, Any] = {"time": time.time(), "type": typ,
                              "state": self.state}
        if node_id is not None:
            ev["node"] = node_id
        ev.update(detail)
        self.events.append(ev)

    def recent_events(self, last: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self.events)
        last = int(last)
        return evs[-last:] if last > 0 else []

    def add_node(self, node: Node) -> None:
        with self._lock:
            fresh = node.id not in self._nodes
            self._nodes[node.id] = node
            self._update_state()
            if fresh:
                self.placement_gen += 1
                self._note_event("node-join", node.id, uri=node.uri)
            self.save()

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            removed = self._nodes.pop(node_id, None)
            self.down_ids.discard(node_id)
            self._update_state()
            if removed is not None:
                self.placement_gen += 1
                self._note_event("node-leave", node_id)
            self.save()

    def node_by_id(self, node_id: str) -> Optional[Node]:
        with self._lock:
            hit = self._nodes.get(node_id)
            if hit is None and self.prev_nodes is not None:
                # A node can be routable-by-previous-placement (reads
                # during a remove-node resize) without being a member.
                hit = next((n for n in self.prev_nodes if n.id == node_id),
                           None)
            return hit

    def _update_state(self) -> None:
        if self.state in (STATE_STARTING, STATE_RESIZING):
            return
        self.state = STATE_DEGRADED if self.down_ids else STATE_NORMAL

    def set_state(self, state: str) -> None:
        with self._lock:
            self.state = state

    # -- failure detection ---------------------------------------------------

    def mark_down(self, node_id: str) -> bool:
        """Failure detector verdict: peer unreachable. DEGRADED while any
        member is down (reference cluster.go:522-533). Returns True when
        this changed the node's state."""
        with self._lock:
            if node_id == self.local.id or node_id not in self._nodes \
                    or node_id in self.down_ids:
                return False
            self.down_ids.add(node_id)
            if self.state == STATE_NORMAL:
                self.state = STATE_DEGRADED
            self._note_event("node-down", node_id)
            return True

    def mark_up(self, node_id: str) -> bool:
        with self._lock:
            if node_id not in self.down_ids:
                return False
            self.down_ids.discard(node_id)
            self.down_ids &= set(self._nodes)
            if self.state == STATE_DEGRADED and not self.down_ids:
                self.state = STATE_NORMAL
            self._note_event("node-up", node_id)
            return True

    # -- resize lifecycle ----------------------------------------------------

    def begin_resize(self, prev: Optional[List[Node]] = None) -> List[Node]:
        """Enter RESIZING, pinning the pre-change placement (reference
        broadcasts ClusterStatus{state: RESIZING}, cluster.go:1070). If a
        second topology change arrives mid-resize the ORIGINAL snapshot is
        kept — data still lives where the oldest placement says. Returns
        the pinned snapshot so callers broadcast EXACTLY what this node
        pinned (reading prev_nodes separately would race a concurrent
        end_resize clearing it)."""
        with self._lock:
            if self.prev_nodes is None:
                self.prev_nodes = (list(prev) if prev is not None
                                   else self.nodes())  # RLock: safe
            self.state = STATE_RESIZING
            self.resize_gen += 1
            self._note_event("resize-begin", gen=self.resize_gen,
                             prev=[n.id for n in self.prev_nodes])
            self.save()
            return list(self.prev_nodes)

    def end_resize(self) -> None:
        """Resize complete (or aborted): adopt the current placement for
        reads and return to NORMAL (reference broadcasts NORMAL after the
        job completes, cluster.go:1048-1060)."""
        with self._lock:
            was_resizing = self.prev_nodes is not None \
                or self.state == STATE_RESIZING
            self.prev_nodes = None
            if self.state == STATE_RESIZING:
                self.state = STATE_NORMAL
            if was_resizing:
                # The new placement takes over for reads: anything
                # keyed on the old placement is now suspect.
                self.placement_gen += 1
                self._note_event("resize-complete", gen=self.resize_gen,
                                 members=sorted(self._nodes))
            self.save()

    # -- placement ----------------------------------------------------------

    def shard_nodes(self, index: str, shard: int,
                    previous: bool = False) -> List[Node]:
        """Primary + replicas for a shard (reference ShardNodes,
        cluster.go:840). previous=True computes against the pre-resize
        snapshot (falls back to current when not resizing)."""
        with self._lock:
            if previous and self.prev_nodes is not None:
                nodes = sorted(self.prev_nodes, key=lambda n: n.id)
            else:
                nodes = self.nodes()
        idxs = shard_nodes(index, shard, len(nodes), self.replica_n,
                           self.partition_n)
        return [nodes[i] for i in idxs]

    def write_nodes(self, index: str, shard: int) -> List[Node]:
        """Nodes a write must reach: current owners, plus — during a
        resize — the pre-change owners (old owners still serve reads, new
        owners may already have pulled; writing to the union closes the
        window where a write lands only on one side)."""
        cur = self.shard_nodes(index, shard)
        with self._lock:
            resizing = self.state == STATE_RESIZING and \
                self.prev_nodes is not None
        # widening-only guard: a resize
        # STARTING after the check loses nothing (cur is the union
        # source both sides agree on until prev_nodes is set), and
        # shard_nodes(previous=True) re-validates prev_nodes under the
        # lock — a resize FINISHING in the window falls back to the
        # current epoch. Read routing, where staleness undercounted,
        # is route_shards — check and act in ONE acquisition.
        if not resizing:
            return cur
        prev = self.shard_nodes(index, shard, previous=True)
        seen = {n.id for n in prev}
        return prev + [n for n in cur if n.id not in seen]

    def route_shards(self, index: str, shards: List[int],
                     exclude_ids: Optional[set] = None
                     ) -> "tuple[Dict[str, List[int]], bool]":
        """shards_by_node with the RESIZING check made ATOMICALLY with
        the placement computation, returning (by_node, used_previous).
        A topology change landing between a caller's separate state
        read and its placement math could otherwise route a shard to a
        just-joined owner that has not pulled yet — which answers
        without error and the merge silently undercounts (caught live
        by tools/chaos.py: a TopN missing exactly one shard during a
        join). The RLock makes the nested per-shard placement reads
        consistent with the state check."""
        with self._lock:
            previous = self.state == STATE_RESIZING
            return self.shards_by_node(index, shards,
                                       exclude_ids=exclude_ids,
                                       previous=previous), previous

    def owners_match_membership(self, member_ids: List[str]) -> bool:
        """True when this node's membership equals `member_ids` — used to
        ignore a resize-complete broadcast for a topology this node has
        already moved past (overlapping resizes)."""
        return self.member_ids() == sorted(member_ids)

    def owns_shard(self, index: str, shard: int) -> bool:
        return any(n.id == self.local.id
                   for n in self.shard_nodes(index, shard))

    def is_primary(self, index: str, shard: int) -> bool:
        sn = self.shard_nodes(index, shard)
        return bool(sn) and sn[0].id == self.local.id

    def shards_by_node(self, index: str, shards: List[int],
                       exclude_ids: Optional[set] = None,
                       previous: bool = False) -> Dict[str, List[int]]:
        """Group shards by serving node id, preferring the primary and
        falling back down the replica chain when primaries are excluded
        (the mapReduce retry path, executor.go:2313-2324). Replicas the
        failure detector marks down are deprioritized — proactive
        failover: a dead node costs zero request timeouts — but still
        usable as a last resort (the detector may be stale)."""
        with self._lock:
            down = set(self.down_ids)
        out: Dict[str, List[int]] = {}
        for shard in shards:
            cands = [n for n in self.shard_nodes(index, shard,
                                                 previous=previous)
                     if not (exclude_ids and n.id in exclude_ids)]
            pick = next((n for n in cands if n.id not in down), None)
            if pick is None and cands:
                pick = cands[0]
            if pick is None:
                raise RuntimeError(
                    f"shard {shard} unavailable: all replicas excluded")
            out.setdefault(pick.id, []).append(shard)
        return out

    # -- persistence (reference .topology, cluster.go:1611-1646) ------------

    def save(self) -> None:
        if not self.topology_path:
            return
        tmp = self.topology_path + ".tmp"
        doc = {"nodes": [n.to_json() for n in self.nodes()],
               "replicaN": self.replica_n}
        if self.translate_primary_id is not None:
            doc["translatePrimary"] = self.translate_primary_id
        if self.prev_nodes is not None:
            # Survive a restart mid-resize: reads keep the safe pre-change
            # placement until the job (or an abort) finishes.
            doc["resizing"] = True
            doc["prevNodes"] = [n.to_json() for n in self.prev_nodes]
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.topology_path)

    def load(self) -> None:
        if not self.topology_path or not os.path.exists(self.topology_path):
            return
        with open(self.topology_path) as f:
            data = json.load(f)
        with self._lock:
            for nd in data.get("nodes", []):
                node = Node.from_json(nd)
                if node.id != self.local.id:
                    self._nodes[node.id] = node
            self.replica_n = data.get("replicaN", self.replica_n)
            if data.get("translatePrimary"):
                self.translate_primary_id = data["translatePrimary"]
            if data.get("resizing"):
                self.prev_nodes = [Node.from_json(nd)
                                   for nd in data.get("prevNodes", [])]
                self.state = STATE_RESIZING

    def status(self) -> dict:
        with self._lock:
            out = {"state": self.state,
                   "localID": self.local.id,
                   "replicaN": self.replica_n,
                   "placementGen": self.placement_gen,
                   "nodes": [{**n.to_json(),
                              "state": ("DOWN" if n.id in self.down_ids
                                        else "READY")}
                             for n in self.nodes()]}
            if self.prev_nodes is not None:
                out["prevNodes"] = [n.to_json() for n in self.prev_nodes]
            # Always report the EFFECTIVE allocator (falls back to the
            # lexically-first member before any explicit pin) so an
            # operator can identify it on a static cluster too.
            out["translatePrimary"] = self.translate_primary().id
            return out
