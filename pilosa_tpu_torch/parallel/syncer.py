"""Anti-entropy replica sync and the resize's fragment movement, after
the JAX package's ``parallel/syncer.py``.

``HolderSyncer`` reconciles every fragment this node owns with its
other owners block by block, SYNC_WORKERS shards at a time (a shard's
fragments one after another, in the order the JAX package walks them):
the block digests of both sides (``Fragment.checksum_blocks``), then
the pairs of each differing block, merged here as a union and the
peer's missing pairs pushed back as an import; a peer without the
fragment gets it whole (its schema made first). Attribute stores are
reconciled the same way with every peer. ``ResizePuller`` is the
resize's data motion: after a topology change it fetches each fragment
this node now owns from the most authoritative holder and replaces its
copy; ``clean_unowned`` drops the fragments it no longer owns.
``AntiEntropyLoop`` runs a sync pass every interval.

Reference: holderSyncer (holder.go:637-858), fragmentSyncer
(fragment.go:2231-2432), holderCleaner (holder.go:859) and
followResizeInstruction (cluster.go:1251), here pull-based.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.parallel.client import ClientError, InternalClient
from pilosa_tpu_torch.parallel.cluster import STATE_RESIZING, Cluster
from pilosa_tpu_torch.utils.failpoints import FAILPOINTS
from pilosa_tpu_torch.utils.locks import make_lock

# Each (peer, shard) fetch of a resize pull: `error` fails the pull pass
# (the job stays RESIZING, reads keep the pre-change placement), `delay`
# holds the cluster mid-resize.
_FP_RESIZE_PULL = FAILPOINTS.register("resize.pull")

# Shards a sync pass reconciles at once. A shard's pushes write only the
# peer's fragments of that shard, so shards are independent; a cold
# pass is bound by hashing (which, like the C++ position sweep, runs
# without the GIL) on this node and on the peers it asks.
SYNC_WORKERS = 8


class HolderSyncer:
    """One anti-entropy pass over the holder (``sync_holder``)."""

    def __init__(self, holder, cluster: Cluster,
                 client: Optional[InternalClient] = None, logger=None):
        self.holder = holder
        self.cluster = cluster
        self.client = client or InternalClient()
        self.logger = logger

    def _log(self, fmt, *args):
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def sync_holder(self) -> Dict[str, int]:
        """Reconcile every attribute store with every peer and every
        fragment this node owns with its other owners. Returns the bits
        and attributes taken here (``merged``, ``attrs_merged``) and
        sent to peers (``pushed``, ``attrs_pushed``)."""
        stats = {"merged": 0, "pushed": 0, "attrs_merged": 0,
                 "attrs_pushed": 0}
        shards: Dict[tuple, list] = {}
        for iname, idx in list(self.holder.indexes.items()):
            self.sync_attrs(iname, None, idx.column_attr_store, stats)
            for fname, field in list(idx.fields.items()):
                self.sync_attrs(iname, fname, field.row_attr_store, stats)
                for vname, view in list(field.views.items()):
                    for shard, frag in list(view.fragments.items()):
                        if self.cluster.owns_shard(iname, shard):
                            shards.setdefault((iname, shard), []).append(
                                (iname, fname, vname, shard, frag))

        def run(jobs):
            # One shard's fragments one after another, in index, field
            # and view order: a push writes the peer's fragments of the
            # same shard (the field's and `_exists`), so a later
            # comparison in this shard must see it, as it does when the
            # whole pass runs in this order.
            part = {"merged": 0, "pushed": 0}
            for job in jobs:
                self.sync_fragment(*job, part)
            return part

        with ThreadPoolExecutor(max_workers=SYNC_WORKERS) as pool:
            for part in pool.map(run, shards.values()):
                stats["merged"] += part["merged"]
                stats["pushed"] += part["pushed"]
        return stats

    def sync_attrs(self, index: str, field: Optional[str], store,
                   stats: Dict[str, int]) -> None:
        """Block-digest reconciliation of one attribute store with every
        peer: a differing block is pulled and merged here (a key-wise
        union, the last writer winning a key), and this node's copy of
        it pushed back, so both sides converge."""
        peers = [n for n in self.cluster.nodes()
                 if n.id != self.cluster.local.id]
        for peer in peers:
            try:
                theirs = {b["block"]: b["checksum"]
                          for b in self.client.attr_blocks(peer.uri, index,
                                                           field)}
            except ClientError as e:
                self._log("attr sync: blocks from %s failed: %r",
                          peer.uri, e)
                continue
            ours = {b: c.hex() for b, c in store.blocks()}
            for block in set(theirs) | set(ours):
                if theirs.get(block) == ours.get(block):
                    continue
                try:
                    if block in theirs:
                        data = self.client.attr_block_data(
                            peer.uri, index, field, block)
                        if data:
                            store.set_bulk({int(i): a
                                            for i, a in data.items()})
                            stats["attrs_merged"] += len(data)
                    local = store.block_data(block)
                    if local:
                        self.client.attr_merge(
                            peer.uri, index, field,
                            {str(i): a for i, a in local.items()})
                        stats["attrs_pushed"] += len(local)
                except ClientError as e:
                    self._log("attr sync: block %d with %s failed: %r",
                              block, peer.uri, e)

    def sync_fragment(self, index: str, field: str, view: str, shard: int,
                      frag, stats: Dict[str, int]) -> None:
        """Reconcile one fragment with the shard's other owners (a peer
        without it gets it whole)."""
        peers = [n for n in self.cluster.shard_nodes(index, shard)
                 if n.id != self.cluster.local.id]
        if not peers:
            return
        local_blocks = dict(frag.checksum_blocks())
        for peer in peers:
            try:
                their = {b["block"]: bytes.fromhex(b["checksum"])
                         for b in self.client.fragment_blocks(
                             peer.uri, index, field, view, shard)}
            except ClientError:
                # The peer lacks the fragment: push ours whole, its
                # schema first (a peer that missed a schema broadcast).
                try:
                    self._ensure_remote_schema(peer, index, field)
                    self.client.import_roaring_node(
                        peer.uri, index, field, shard, frag.write_bytes(),
                        view=view)
                    stats["pushed"] += frag.storage.count()
                except ClientError as e:
                    self._log("sync push to %s failed: %s", peer.id, e)
                continue
            for block in set(local_blocks) | set(their):
                if local_blocks.get(block) == their.get(block):
                    continue
                self._sync_block(index, field, view, shard, frag, peer,
                                 block, stats)

    def _ensure_remote_schema(self, peer, index: str, field: str) -> None:
        idx = self.holder.index(index)
        if idx is None:
            return
        f = idx.field(field)
        self.client.create_index_node(
            peer.uri, index, {"keys": idx.keys,
                              "trackExistence": idx.track_existence})
        if f is not None and not field.startswith("_"):
            # Internal fields (_exists) come with the index.
            o = f.options
            self.client.create_field_node(
                peer.uri, index, field,
                {"type": o.type, "cacheType": o.cache_type,
                 "cacheSize": o.cache_size, "min": o.min, "max": o.max,
                 "timeQuantum": o.time_quantum, "keys": o.keys,
                 "noStandardView": o.no_standard_view,
                 "maxColumns": o.max_columns})

    def _sync_block(self, index, field, view, shard, frag, peer, block,
                    stats) -> None:
        """One differing block: the peer's pairs merged here, the pairs
        it lacks pushed to it as an import (to the field's import
        route, as the JAX package sends them, whatever the view)."""
        try:
            data = self.client.block_data(peer.uri, index, field, view,
                                          shard, block)
        except ClientError:
            data = {"rows": [], "columns": []}
        (here_r, _here_c), (there_r, there_c) = frag.merge_block(
            block, np.asarray(data["rows"], dtype=np.uint64),
            np.asarray(data["columns"], dtype=np.uint64))
        stats["merged"] += len(here_r)
        if len(there_r):
            try:
                self.client.import_node(
                    peer.uri, index, field,
                    {"rowIDs": [int(r) for r in there_r],
                     "columnIDs": [int(c) for c in there_c]})
                stats["pushed"] += len(there_r)
            except ClientError as e:
                self._log("block push to %s failed: %s", peer.id, e)


class ResizePuller:
    """The resize's data motion on one node: ``pull_owned`` fetches every
    fragment this node now owns (a replace), ``clean_unowned`` drops the
    ones it no longer owns."""

    def __init__(self, holder, cluster: Cluster,
                 client: Optional[InternalClient] = None, logger=None):
        self.holder = holder
        self.cluster = cluster
        self.client = client or InternalClient()
        self.logger = logger
        # Overlapping resize jobs may both ask this node to pull; the
        # passes are idempotent but their schema writes race, so they
        # run one at a time.
        self._pull_lock = make_lock("ResizePuller._pull_lock")

    def _log(self, fmt, *args):
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def pull_owned(self) -> int:
        """One pull pass; returns the fragments fetched. The cluster's
        state belongs to the resize job (``API._start_resize_job``): it
        stays RESIZING through the pull, so reads keep the pre-change
        placement."""
        with self._pull_lock:
            return self._pull_owned_locked()

    def _pull_owned_locked(self) -> int:
        # Sources: the members and the pre-resize members. After a
        # remove-node the only holder of a shard may be the node being
        # removed (alive, detached), reachable through the snapshot.
        peers = [n for n in self.cluster.known_nodes()
                 if n.id != self.cluster.local.id]
        if not peers:
            return 0
        fetched = 0
        # The peers' schemas (made here where missing) and which peer
        # holds which shard.
        holders: Dict[tuple, list] = {}
        for peer in peers:
            try:
                schema = self.client.schema(peer.uri)
            except ClientError:
                continue
            for idx_info in schema.get("indexes", []):
                iname = idx_info["name"]
                idx = self.holder.index(iname)
                if idx is None:
                    idx = self.holder.create_index(
                        iname, keys=idx_info["options"].get("keys", False),
                        track_existence=idx_info["options"].get(
                            "trackExistence", True))
                for f_info in idx_info.get("fields", []):
                    if idx.field(f_info["name"]) is None:
                        o = f_info["options"]
                        idx.create_field(f_info["name"], FieldOptions(
                            type=o.get("type", "set"),
                            cache_type=o.get("cacheType", "ranked"),
                            cache_size=o.get("cacheSize", 50000),
                            min=o.get("min", 0), max=o.get("max", 0),
                            time_quantum=o.get("timeQuantum", ""),
                            keys=o.get("keys", False),
                            no_standard_view=o.get("noStandardView",
                                                   False),
                            max_columns=o.get("maxColumns", 0)))
                for shard in idx_info.get("shards", []):
                    holders.setdefault((iname, int(shard)), []).append(peer)
        # Each owned shard from the most authoritative holder first: the
        # pre-change owners (they took every write of the ending epoch),
        # then the current owners, then any holder. A lingering old copy
        # may be epochs stale.
        for (iname, shard), hold in holders.items():
            idx = self.holder.index(iname)
            if idx is None or not self.cluster.owns_shard(iname, shard):
                continue
            # A node regaining ownership may hold a copy from an older
            # epoch that missed every write since: it refreshes from the
            # authoritative holder. A pre-change owner's copy is current.
            local = self.cluster.local.id
            was_owner = any(
                n.id == local
                for n in self.cluster.shard_nodes(iname, shard,
                                                  previous=True))
            for peer in self._source_order(iname, shard, hold):
                got = self._maybe_pull(peer, idx, shard,
                                       refresh=not was_owner)
                fetched += got
                if got:
                    # Refreshed from the most authoritative holder; the
                    # later ones only fill views it lacked.
                    was_owner = True
        return fetched

    def _source_order(self, index: str, shard: int, holders: list) -> list:
        by_id = {n.id: n for n in holders}
        ordered = []
        for previous in (True, False):
            for n in self.cluster.shard_nodes(index, shard,
                                              previous=previous):
                if n.id in by_id:
                    ordered.append(by_id.pop(n.id))
        ordered.extend(by_id.values())
        return ordered

    def _maybe_pull(self, peer, idx, shard: int,
                    refresh: bool = False) -> int:
        """Fetch from ``peer`` the shard's fragments this node lacks;
        ``refresh`` fetches the ones it holds too (ownership was just
        regained, the local copy may be stale)."""
        if not self.cluster.owns_shard(idx.name, shard):
            return 0
        # An injected error is no ClientError, so it leaves the pass
        # and fails the resize job's pull: the cluster stays RESIZING.
        _FP_RESIZE_PULL.fire(uri=peer.uri, index=idx.name, shard=shard)
        fetched = 0
        for fname, field in list(idx.fields.items()):
            try:
                views = self.client.views(peer.uri, idx.name, fname)
            except ClientError:
                continue
            for vname in views:
                view = field.view(vname)
                held = view is not None and view.fragment(shard) is not None
                if held and not refresh:
                    continue  # held: anti-entropy reconciles it
                try:
                    data = self.client.retrieve_shard(
                        peer.uri, idx.name, fname, vname, shard)
                except ClientError:
                    continue
                frag = field.create_view_if_not_exists(vname) \
                    .create_fragment_if_not_exists(shard)
                # A replace, not a union: a stale copy must not resurrect
                # bits cleared while this node was no owner. A write that
                # reached only this node in the resize window (every
                # other owner's leg failed) is dropped here; the
                # reference refuses writes while RESIZING (api.go:76-99).
                frag.replace_with_bytes(data)
                fetched += 1
                self._log("resize: pulled %s/%s/%s/shard %s from %s",
                          idx.name, fname, vname, shard, peer.id)
        return fetched

    def clean_unowned(self) -> int:
        """Drop the fragments this node no longer owns, with their
        files, banks and rank vectors; returns how many. Never while
        RESIZING: reads still route by the pre-change placement, so an
        old owner's copy is live data."""
        if self.cluster.state == STATE_RESIZING:
            return 0
        removed = 0
        for iname, idx in list(self.holder.indexes.items()):
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    for shard in list(view.fragments):
                        if self.cluster.owns_shard(iname, shard):
                            continue
                        if view.remove_fragment(shard) is not None:
                            idx.rank_cache.invalidate_shards(
                                {(iname, shard)})
                            removed += 1
        return removed


class AntiEntropyLoop:
    """A sync pass every ``interval`` seconds on a daemon thread (none
    when the interval is 0); a failed pass is logged and the loop goes
    on (reference monitorAntiEntropy, server.go:430)."""

    def __init__(self, syncer: HolderSyncer, interval: float):
        self.syncer = syncer
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.interval <= 0:
            return

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.syncer.sync_holder()
                except Exception as e:  # keep the loop alive, but say why
                    self.syncer._log("anti-entropy pass failed: %s: %s",
                                     type(e).__name__, e)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
