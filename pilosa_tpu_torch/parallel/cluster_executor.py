"""Multi-node scatter-gather execution over HTTP.

Reference: reference executor.go:2277-2415 (mapReduce): group shards
by owning node, execute local shards locally, POST the query to remote
nodes with explicit shard lists (`opt.Remote=true` so remotes do not
re-fan-out), stream-reduce responses, and on node failure re-map that
node's shards onto remaining replicas (:2313-2324).

Reduction here happens on the JSON result shapes (the wire format), one
merge rule per call type — the associative reduceFn table
(executor.go:481-488, row.go:60, cache.go:356).

After the JAX package's ``parallel/cluster_executor.py``. Each node is
one process with one card: the coordinator's own leg runs its shard
subset through the local executor (the card's kernels), and only the
per-leg answers meet the HTTP merge table below. HTTP is the failure
domain: failover, hedged reads and the deadline budget act per leg.
The merge is the reference's: TopN sums each leg's top-n in one pass
and orders ties by ``str(id)``; GroupBy orders groups by ``str(group)``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from pilosa_tpu_torch.utils.locks import make_lock
from pilosa_tpu_torch.utils.stats import NopStatsClient
from pilosa_tpu_torch.utils.timeline import LANE_REMOTE, TIMELINE
from typing import Any, Dict, List, Optional, Sequence

from pilosa_tpu_torch.executor.results import result_to_json
from pilosa_tpu_torch.parallel.client import ClientError, InternalClient
from pilosa_tpu_torch.parallel.cluster import Cluster
from pilosa_tpu_torch.pql import Call, parse_string_cached
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH

_WRITE_SINGLE_COL = {"Set", "Clear"}
# Attr writes go to every node (reference executeSetRowAttrs /
# executeSetColumnAttrs fan to all nodes, executor.go:2063-2080,2225-2240),
# so any coordinator can serve columnAttrs from its local store.
_WRITE_BROADCAST = {"ClearRow", "Store", "SetRowAttrs", "SetColumnAttrs"}


def merge_results(call: Call, parts: List[Any]) -> Any:
    """Associative merge of per-node JSON results for one call."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    # Options() wraps one child; per-node results have the child's shape,
    # so merge by the child's rule (reference reduces on the inner call).
    while call.name == "Options" and call.children:
        call = call.children[0]
    if len(parts) == 1:
        return parts[0]
    name = call.name
    if name == "Count":
        return sum(parts)
    if name in ("Row", "Range", "Intersect", "Union", "Difference", "Xor",
                "Not", "Shift"):
        cols = sorted(set().union(
            *[set(p.get("columns", [])) for p in parts]))
        out = {"columns": cols}
        if any("keys" in p for p in parts):
            # Keep columns[i] <-> keys[i] positional alignment: merge each
            # node's aligned pairs into one map, then emit keys in merged
            # column order.
            by_col = {c: k for p in parts
                      for c, k in zip(p.get("columns", []),
                                      p.get("keys", []))}
            out["keys"] = [by_col.get(c, str(c)) for c in cols]
        attrs = next((p["attrs"] for p in parts if p.get("attrs")), None)
        if attrs:
            out["attrs"] = attrs
        return out
    if name == "TopN":
        acc: Dict[Any, int] = {}
        keyed = any(p and isinstance(p[0], dict) and "key" in p[0]
                    for p in parts if p)
        for p in parts:
            for pair in p:
                k = pair.get("key", pair.get("id"))
                acc[k] = acc.get(k, 0) + pair["count"]
        ordered = sorted(acc.items(), key=lambda kv: (-kv[1], str(kv[0])))
        n = call.uint_arg("n") or 0
        if n:
            ordered = ordered[:n]
        if keyed:
            return [{"key": k, "count": c} for k, c in ordered]
        return [{"id": k, "count": c} for k, c in ordered]
    if name == "Rows":
        limit = call.uint_arg("limit")
        if any("keys" in p for p in parts):
            keys = sorted(set().union(*[set(p.get("keys", []))
                                        for p in parts]))
            return {"keys": keys[:limit] if limit else keys}
        rows = sorted(set().union(*[set(p.get("rows", [])) for p in parts]))
        return {"rows": rows[:limit] if limit else rows}
    if name == "GroupBy":
        acc: Dict[str, dict] = {}
        for p in parts:
            for gc in p:
                key = str(gc["group"])
                if key in acc:
                    acc[key]["count"] += gc["count"]
                else:
                    acc[key] = dict(gc)
        out = sorted(acc.values(), key=lambda g: str(g["group"]))
        limit = call.uint_arg("limit")
        return out[:limit] if limit else out
    if name == "Sum":
        return {"value": sum(p["value"] for p in parts),
                "count": sum(p["count"] for p in parts)}
    if name in ("Min", "Max"):
        nonzero = [p for p in parts if p["count"] > 0]
        if not nonzero:
            return {"value": 0, "count": 0}
        pick = min if name == "Min" else max
        best = pick(p["value"] for p in nonzero)
        return {"value": best,
                "count": sum(p["count"] for p in nonzero
                             if p["value"] == best)}
    if name in _WRITE_SINGLE_COL | _WRITE_BROADCAST:
        return any(bool(p) for p in parts)
    return parts[0]


class _Leg:
    """Accounting for one scatter leg of a fan-out round: the shards it
    must deliver, a first-success-wins settle latch (`done` — primary
    vs hedge must never both merge), and the count of in-flight
    attempts (`pending`) so the leg only reads as failed when EVERY
    attempt for it has failed. `event` fires when the primary attempt
    concludes (the hedge monitor waits on it)."""

    __slots__ = ("node", "shards", "done", "pending", "event")

    def __init__(self, node, shards: Sequence[int]) -> None:
        self.node = node
        self.shards = list(shards)
        self.done = False
        self.pending = 1
        self.event = threading.Event()


class ClusterExecutor:
    """Coordinator-side fan-out. Wraps a local Executor; remote legs use
    InternalClient. Replica failover: a failed node's shards re-map onto
    the next replica (reference executor.go:2313-2324).

    Fan-out hardening (the resilience plane, docs/architecture.md):

    - a per-request **deadline budget** (`fanout_deadline_s`) is
      propagated to every remote leg as its RPC timeout, so one wedged
      peer can never hold a request past the budget;
    - failover rounds back off **exponentially with jitter**
      (`backoff_base_s`/`backoff_cap_s`) instead of hammering a
      recovering cluster;
    - routing honors the failure detector (heartbeat `mark_down`):
      `shards_by_node` deprioritizes down replicas per shard, so a
      known-dead node costs zero request timeouts yet stays usable as
      the last resort for a shard with no up candidate (the detector
      may be stale); the per-request skip is counted
      (`cluster.excluded_nodes`);
    - optional **hedged reads** (`hedge_quantile` > 0): a leg slower
      than that quantile of the recent leg-latency window is re-issued
      to a spare replica, first success wins;
    - **shard accounting**: every scatter leg must deliver its shards
      or the round fails over — ANY exception (not just ClientError)
      marks the leg failed, and a post-join audit confirms every shard
      merged (a lost partition can never silently undercount)."""

    FANOUT_DEADLINE_S = 30.0
    BACKOFF_BASE_S = 0.05
    BACKOFF_CAP_S = 2.0
    HEDGE_QUANTILE = 0.0  # 0 disables hedged reads
    HEDGE_FLOOR_S = 0.005
    HEDGE_MIN_SAMPLES = 8

    def __init__(self, local_executor, cluster: Cluster,
                 client: Optional[InternalClient] = None, logger=None,
                 broadcaster=None, stats=None):
        self.local = local_executor
        self.cluster = cluster
        self.client = client or InternalClient()
        self.logger = logger
        self.stats = stats or NopStatsClient()
        # Optional queued-retry path for the shards-changed push (a
        # briefly-down peer otherwise serves undercounts for up to the
        # TTL after it returns).
        self.broadcaster = broadcaster
        self.fanout_deadline_s = self.FANOUT_DEADLINE_S
        self.backoff_base_s = self.BACKOFF_BASE_S
        self.backoff_cap_s = self.BACKOFF_CAP_S
        self.hedge_quantile = self.HEDGE_QUANTILE
        # Rolling window of successful remote-leg durations; the hedge
        # trigger is a quantile of this window, so "slow" means slow
        # relative to THIS cluster's live behavior, not a magic number.
        self._leg_lat: "deque[float]" = deque(maxlen=128)
        self._leg_lat_lock = make_lock("ClusterExecutor._leg_lat_lock")
        # index -> (monotonic time, every node's shards): global_shards'
        # TTL cache; and index -> every shard a write through this
        # coordinator touched (note_written_shards).
        self._shards_cache: Dict[str, tuple] = {}
        self._known_shards: Dict[str, set] = {}

    def configure(self, fanout_deadline_s: Optional[float] = None,
                  backoff_base_s: Optional[float] = None,
                  backoff_cap_s: Optional[float] = None,
                  hedge_quantile: Optional[float] = None) -> None:
        """[cluster] config wiring (cli/main.py)."""
        if fanout_deadline_s is not None:
            self.fanout_deadline_s = float(fanout_deadline_s)
        if backoff_base_s is not None:
            self.backoff_base_s = max(0.0, float(backoff_base_s))
        if backoff_cap_s is not None:
            self.backoff_cap_s = max(0.0, float(backoff_cap_s))
        if hedge_quantile is not None:
            self.hedge_quantile = min(1.0, max(0.0,
                                               float(hedge_quantile)))

    def _hedge_delay(self) -> Optional[float]:
        """How long a leg may run before it is hedged, or None when
        hedging is off or the latency window is too thin to name a
        quantile."""
        q = self.hedge_quantile
        if not q:
            return None
        with self._leg_lat_lock:
            lats = sorted(self._leg_lat)
        if len(lats) < self.HEDGE_MIN_SAMPLES:
            return None
        return max(self.HEDGE_FLOOR_S,
                   lats[min(len(lats) - 1, int(len(lats) * q))])

    # -- shard discovery ----------------------------------------------------

    GLOBAL_SHARDS_TTL = 2.0

    def global_shards(self, index: str) -> List[int]:
        """Union of every node's locally-available shards, TTL-cached (the
        reference instead broadcasts availableShards on change,
        field.go:228 — a push model; a short pull cache gives the same
        read-path behavior without a broadcast bus)."""
        cache = self._shards_cache
        hit = cache.get(index)
        if hit is not None and time.monotonic() - hit[0] < \
                self.GLOBAL_SHARDS_TTL:
            return hit[1]
        shards = set()
        idx = self.local.holder.index(index)
        if idx is not None:
            shards.update(idx.available_shards())
        # During a resize, data may live only on a pre-change member (e.g.
        # a just-removed node) — ask the union of current and previous
        # membership so discovery cannot miss shards mid-move.
        for node in self.cluster.known_nodes():
            if node.id == self.cluster.local.id:
                continue
            try:
                per_index = self.client.local_shards(node.uri)
                shards.update(per_index.get(index, []))
            except ClientError:
                continue
        out = sorted(shards) or [0]
        cache[index] = (time.monotonic(), out)
        return out

    def invalidate_shards_cache(self, index: str) -> None:
        """Drop the cached global shard list after a write through this
        coordinator (read-your-own-writes for newly created shards)."""
        self._shards_cache.pop(index, None)

    def note_written_shards(self, index: str, shards) -> None:
        """A completed write touched `shards`: invalidate locally and —
        when any shard is NEW to this coordinator — tell every routable
        node (current ∪ pre-resize members: a departing node still
        serving reads mid-resize needs the push too) to drop its cached
        list. Without the push, another node could serve an undercount
        for up to GLOBAL_SHARDS_TTL after the first write lands in a
        brand-new shard (the reference instead broadcasts
        CreateShardMessage on fragment creation, view.go:221).
        Suppression uses a MONOTONE per-index known-shards set — not the
        TTL cache, which this method itself invalidates — so steady-
        state writes into known shards genuinely broadcast nothing.
        Call AFTER the write has been applied/fanned out: peers
        re-discover on their next read, which must find the data."""
        seen = self._known_shards.setdefault(index, set())
        fresh = [int(s) for s in shards if int(s) not in seen]
        seen.update(int(s) for s in shards)
        self.invalidate_shards_cache(index)
        if not fresh:
            return
        for node in self.cluster.known_nodes():
            if node.id == self.cluster.local.id:
                continue
            msg = {"type": "shards-changed", "index": index}
            if self.broadcaster is not None:
                # Sync-first: the import ack must mean reachable peers
                # already dropped their shard caches (queue-only opened
                # a read-your-writes-via-another-node window). Down
                # peers get ONE queued copy (coalesce), not a backlog.
                self.broadcaster.send_now_or_queue(node.uri, msg,
                                                   coalesce=True)
                continue
            try:
                self.client.cluster_message(node.uri, msg)
            except ClientError:
                pass

    # -- query --------------------------------------------------------------

    def execute(self, index: str, query: str,
                shards: Optional[Sequence[int]] = None,
                profile=None) -> List[Any]:
        """Returns JSON-shaped results (one per call). `profile` (a
        utils/profile QueryProfile) records the coordinator's local leg
        in its own tree; when it is a forced profile (?profile=true)
        the flag also propagates to every remote leg and the per-node
        fragments merge under profile.nodes — a cross-node query then
        shows where its time went, node by node."""
        from pilosa_tpu_torch.executor.executor import (
            ExecutionError, write_call_count,
        )
        q = parse_string_cached(query) if isinstance(query, str) else query
        limit = self.local.max_writes_per_request
        if limit > 0 and write_call_count(q) > limit:
            # (reference ErrTooManyWrites, executor.go:106)
            raise ExecutionError("too many write commands")
        return [self._execute_call(index, call, shards, profile=profile)
                for call in q.calls]

    def _execute_call(self, index: str, call: Call, shards,
                      profile=None) -> Any:
        inner = call
        while inner.name == "Options" and inner.children:
            # Options(shards=[...]) overrides the scatter set at the
            # coordinator (reference executeOptionsCall, executor.go:344-359).
            # The arg is *consumed* here: the forwarded call must not carry
            # it, or each node would re-override its per-node shard subset
            # with the full list and replicated shards would double-count.
            opt_shards = inner.args.pop("shards", None)
            if isinstance(opt_shards, (list, tuple)):
                shards = [int(s) for s in opt_shards]
            inner = inner.children[0]
        if inner.name in _WRITE_SINGLE_COL:
            return self._execute_write_single(index, inner)
        if inner.name in _WRITE_BROADCAST:
            self.invalidate_shards_cache(index)
            return self._execute_write_broadcast(index, inner)
        all_shards = list(shards) if shards is not None \
            else self.global_shards(index)
        return self._map_reduce(index, call, all_shards, profile=profile)

    def _map_reduce(self, index: str, call: Call, shards: List[int],
                    profile=None) -> Any:
        # While RESIZING, reads route against the pre-change placement:
        # those nodes are guaranteed to still hold the data (pulls never
        # delete source copies), where the new placement may point at an
        # owner that has not pulled yet and would silently undercount
        # (reference instead rejects queries in RESIZING, api.go:76-99).
        # The check is made atomically with the placement math inside
        # Cluster.route_shards — reading the state separately leaves a
        # window where a landing join routes a shard to the unpulled
        # joiner (a live chaos-harness find).
        # Remote profile propagation only for forced profiles
        # (?profile=true): passive sampling must not make every fan-out
        # leg pay device fencing on its node.
        want_profile = profile is not None and getattr(profile, "forced",
                                                       False)
        # Trace context for the fan-out: captured HERE, on the calling
        # thread (where the request's span/extracted id lives), because
        # the scatter threads below have neither — without an explicit
        # hand-off their query POSTs carry no traceparent and the
        # remote legs record under fresh trace ids (the old stitching
        # only appeared to work via a stale-thread-local side channel).
        tracer = getattr(self.client, "tracer", None)
        trace_id = getattr(profile, "trace_id", None) \
            if profile is not None else None
        if trace_id is None and hasattr(tracer, "current_trace_id"):
            trace_id = tracer.current_trace_id()
        deadline = (time.monotonic() + self.fanout_deadline_s) \
            if self.fanout_deadline_s > 0 else None

        def remaining() -> Optional[float]:
            return None if deadline is None \
                else deadline - time.monotonic()

        excluded: set = set()
        # Known-down nodes need no request-level exclusion here:
        # shards_by_node deprioritizes down_ids PER SHARD (a down
        # replica is picked only when no up candidate remains —
        # strictly finer than any whole-round exclusion-and-readmit),
        # so a heartbeat-marked node receives zero RPCs unless it is
        # the last resort for some shard (pinned by test). Counted so
        # /metrics shows the proactive skips.
        pre_down = set(self.cluster.down_ids)
        if pre_down:
            self.stats.count("cluster.excluded_nodes", len(pre_down))
        last_err: Optional[Exception] = None
        want_shards = {int(s) for s in shards}
        for attempt in range(max(1, self.cluster.replica_n)):
            if attempt:
                # Failover round: exponential backoff + full jitter,
                # capped and clipped to the remaining deadline budget —
                # a recovering cluster gets breathing room instead of a
                # synchronized retry stampede.
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                delay *= 0.5 + random.random() / 2
                rem = remaining()
                if rem is not None:
                    delay = min(delay, max(0.0, rem))
                if delay > 0:
                    time.sleep(delay)
            rem = remaining()
            if rem is not None and rem <= 0:
                raise last_err or ClientError(
                    f"map_reduce: fan-out deadline "
                    f"({self.fanout_deadline_s:g}s) exhausted")
            try:
                by_node, previous = self.cluster.route_shards(
                    index, shards, exclude_ids=excluded)
            except RuntimeError as e:
                raise last_err or e
            parts: List[Any] = []
            accounted: set = set()
            failed = False
            results_lock = make_lock("ClusterExecutor.results_lock")
            threads: List[threading.Thread] = []
            legs: List[_Leg] = []
            # Set once every leg has concluded (settled or all attempts
            # failed). The gather waits on THIS, not on thread joins —
            # a leg settled by its hedge must not wait out the slow
            # primary's socket.
            gather_evt = threading.Event()

            def _conclude_locked():
                if all(l.done or l.pending <= 0 for l in legs):
                    gather_evt.set()

            def run_remote(node, leg: _Leg, hedge: bool = False):
                nonlocal failed, last_err
                # Scatter threads have no open span: adopt the
                # request's trace id so the outgoing leg injects the
                # SAME traceparent the coordinator received.
                if trace_id and hasattr(tracer, "adopt"):
                    tracer.adopt(trace_id)
                # Remote-leg slice on the coordinator's request
                # timeline: how long this node's scatter-gather round
                # trip took (the remote's own stage slices record on
                # ITS timeline under the same trace id and assemble
                # via /cluster/timeline).
                tl = getattr(profile, "timeline", None) \
                    if profile is not None else None
                lane = f"hedge:{node.id}" if hedge \
                    else f"remote:{node.id}"
                t0 = time.perf_counter()
                try:
                    rem_leg = remaining()
                    if rem_leg is not None and rem_leg <= 0:
                        raise ClientError(
                            f"node {node.id}: fan-out deadline "
                            f"exhausted before dispatch")
                    res = self.client.query_node_full(
                        node.uri, index, call.to_pql(), leg.shards,
                        profile=want_profile, timeout=rem_leg)
                    dur = time.perf_counter() - t0
                    # A malformed response body must take the failure
                    # path below, not tear the thread down silently.
                    part = res["results"][0]
                    # The RPC genuinely succeeded, so its duration is
                    # real signal for the hedge quantile even when the
                    # hedge race is about to discard the result.
                    with self._leg_lat_lock:
                        self._leg_lat.append(dur)
                    with results_lock:
                        if leg.done:
                            return  # hedge race: first success merged
                        leg.done = True
                        parts.append(part)
                        accounted.update(int(s) for s in leg.shards)
                        _conclude_locked()
                    # Winner-only side effects, AFTER settling: the
                    # losing attempt of a hedge race must not add a
                    # second profile fragment (device time would
                    # double-count) or a success slice for a result
                    # that never merged.
                    TIMELINE.event(tl, lane, LANE_REMOTE, t0, dur,
                                   remote=node.id,
                                   shards=len(leg.shards))
                    if want_profile and res.get("profile") is not None:
                        profile.add_node_fragment(node.id,
                                                  res["profile"])
                except Exception as e:
                    # EVERY exception accounts the leg as failed — a
                    # non-ClientError (torn-body JSON decode, a
                    # malformed response shape) previously killed the
                    # scatter thread with `failed` still False and the
                    # merge silently undercounted the lost partition.
                    TIMELINE.event(tl, lane, LANE_REMOTE,
                                   t0, time.perf_counter() - t0,
                                   remote=node.id, error=str(e)[:200])
                    with results_lock:
                        # The node did fail its RPC: excluding it from
                        # later rounds is right either way. But the
                        # failover/loss counters fire only when the
                        # LEG actually lost the result — a late
                        # primary failure after the hedge merged is
                        # not a failover.
                        excluded.add(node.id)
                        lost = not leg.done
                        if lost:
                            leg.pending -= 1
                            if leg.pending <= 0:
                                failed = True
                                last_err = e
                        _conclude_locked()
                    if lost:
                        if not isinstance(e, ClientError):
                            self.stats.count("cluster.partition_losses",
                                             1)
                        self.stats.count("cluster.failovers", 1)
                        if self.logger is not None:
                            self.logger.printf(
                                "node %s failed (%s), failing over: %s",
                                node.id, type(e).__name__, e)
                finally:
                    if not hedge:
                        leg.event.set()

            # Build EVERY leg before starting any thread: a fast leg
            # concluding while later legs are still being appended
            # would otherwise see "all legs concluded" and fire the
            # gather early. Then dispatch every remote leg before
            # running the local one so the local evaluation overlaps
            # the network round trips.
            local_shards = None
            for node_id, node_shards in by_node.items():
                if node_id == self.cluster.local.id:
                    local_shards = node_shards
                else:
                    node = self.cluster.node_by_id(node_id)
                    legs.append(_Leg(node, node_shards))
            for leg in legs:
                t = threading.Thread(target=run_remote,
                                     args=(leg.node, leg), daemon=True)
                t.start()
                threads.append(t)
            if local_shards is not None:
                # The coordinator's own leg records into the root
                # profile directly — its ops ARE the tree's trunk.
                local = self.local.execute(index, call.to_pql(),
                                           shards=local_shards,
                                           profile=profile)
                parts.append(result_to_json(local[0]))
                accounted.update(int(s) for s in local_shards)
            self._maybe_hedge(index, legs, threads, run_remote,
                              excluded, results_lock, previous)
            if legs:
                rem = remaining()
                gather_evt.wait(rem if rem is not None else None)
            with results_lock:
                # Deadline-expired stragglers (the gather timed out
                # with a leg still in flight): latch the leg done so a
                # late settle can never append into a round we have
                # already judged, and account it as a failure.
                for leg in legs:
                    if not leg.done and leg.pending > 0:
                        leg.done = True
                        excluded.add(leg.node.id)
                        failed = True
                        last_err = last_err or ClientError(
                            f"node {leg.node.id}: no response within "
                            f"the fan-out deadline")
                round_ok = not failed
                if round_ok:
                    # Defense in depth behind the Exception catch: the
                    # merge runs ONLY when every requested shard was
                    # delivered by some leg. An unaccounted shard is a
                    # lost partition, never a quiet undercount.
                    missing = want_shards - accounted
                    if missing:
                        round_ok = False
                        failed = True
                        self.stats.count("cluster.partition_losses", 1)
                        last_err = ClientError(
                            f"shards {sorted(missing)} unaccounted "
                            f"after fan-out")
                parts_snapshot = list(parts)
            if round_ok:
                return merge_results(call, parts_snapshot)
            # retry: re-map every shard against remaining nodes
        raise last_err or RuntimeError("map_reduce failed")

    def _maybe_hedge(self, index: str, legs: List[_Leg],
                     threads: List[threading.Thread], run_remote,
                     excluded: set, results_lock,
                     previous: bool) -> None:
        """Hedged reads: a leg whose primary attempt is still in
        flight past the configured latency quantile is re-issued to a
        spare replica — first success wins (the `_Leg.done` latch
        guarantees exactly one merge). Only a replica that can serve
        the WHOLE leg hedges; splitting a leg would split its merge
        accounting."""
        hedge_delay = self._hedge_delay()
        if hedge_delay is None or not legs:
            return
        hedge_at = time.monotonic() + hedge_delay
        for leg in legs:
            wait = hedge_at - time.monotonic()
            if wait > 0:
                leg.event.wait(wait)
            if leg.event.is_set():
                continue  # concluded (or failed — round handles it)
            with results_lock:
                if leg.done or leg.pending <= 0:
                    continue
                avoid = set(excluded) | {leg.node.id}
            try:
                # shards_by_node deprioritizes down-marked replicas
                # itself — no point hedging INTO a dead node.
                alt = self.cluster.shards_by_node(
                    index, leg.shards, exclude_ids=avoid,
                    previous=previous)
            except RuntimeError:
                continue  # no spare replica covers this leg
            if len(alt) != 1:
                continue
            (alt_id, _alt_shards), = alt.items()
            if alt_id == self.cluster.local.id:
                continue
            alt_node = self.cluster.node_by_id(alt_id)
            if alt_node is None:
                continue
            with results_lock:
                if leg.done or leg.pending <= 0:
                    continue
                leg.pending += 1
            self.stats.count("cluster.hedged_reads", 1)
            if self.logger is not None:
                self.logger.printf(
                    "hedging slow leg %s -> replica %s (>%.3fs)",
                    leg.node.id, alt_id, hedge_delay)
            t = threading.Thread(target=run_remote,
                                 args=(alt_node, leg, True),
                                 daemon=True)
            t.start()
            threads.append(t)

    # -- writes -------------------------------------------------------------

    def _execute_write_single(self, index: str, call: Call) -> Any:
        """Route a single-column write to the owning replicas (reference
        executeSetBitField remote fan, executor.go:1959)."""
        col = call.args.get("_col")
        if isinstance(col, str):
            # Translate on the coordinator so every replica stores the
            # same id (translation stores replicate separately).
            self.local._translate_call(self.local.holder.index(index), call)
            col = call.args["_col"]
        shard = int(col) // SHARD_WIDTH
        # write_nodes = current owners ∪ pre-resize owners while RESIZING,
        # so a write can't land only on the side a reader won't consult.
        owners = self.cluster.write_nodes(index, shard)
        result = False
        applied = 0
        last_err: Optional[Exception] = None
        for node in owners:
            if node.id == self.cluster.local.id:
                (r,) = self.local.execute(index, call.to_pql())
                result = result or bool(r)
                applied += 1
            else:
                try:
                    res = self.client.query_node(node.uri, index, call.to_pql(),
                                                 [shard])
                    result = result or bool(res[0])
                    applied += 1
                except ClientError as e:
                    last_err = e
                    if self.logger is not None:
                        self.logger.printf("write to %s failed: %s",
                                           node.id, e)
        if applied == 0:
            # No replica took the write — surfacing the failure is the only
            # honest answer; anti-entropy can only heal from a copy that
            # exists.
            raise last_err or ClientError("no replica accepted the write")
        # After the write landed (keyed columns translated above): push
        # the shard-list invalidation so no peer undercounts a new shard.
        self.note_written_shards(index, [shard])
        return result

    def _execute_write_broadcast(self, index: str, call: Call) -> Any:
        """Row-scoped writes apply on every node (each owns a shard
        subset)."""
        if isinstance(call.args.get("_col"), str):
            # Translate on the coordinator so every node stores the same id.
            self.local._translate_call(self.local.holder.index(index), call)
        results = []
        for node in self.cluster.nodes():
            if node.id == self.cluster.local.id:
                (r,) = self.local.execute(index, call.to_pql())
                results.append(result_to_json(r))
            else:
                try:
                    res = self.client.query_node(node.uri, index,
                                                 call.to_pql(), [])
                    results.append(res[0])
                except ClientError as e:
                    if self.logger is not None:
                        self.logger.printf("broadcast write to %s failed: %s",
                                           node.id, e)
        return merge_results(call, results)
