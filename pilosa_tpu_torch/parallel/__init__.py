"""Distribution, after the JAX package's ``parallel/``.

Within a process: the device mesh (``mesh``: ``MeshContext``,
``ShardPlacement`` and the sharded ``MeshTensor``), the mesh dryrun
(``dryrun``) and the two-process ``torch.distributed`` dryrun
(``multihost``). Across processes, the cluster: shard placement
(``hashing``), topology and failure bookkeeping (``cluster``), the
node-to-node HTTP client (``client``), the queued cluster-message
broadcast (``broadcast``), the coordinator's fan-out with replica
failover (``cluster_executor``), the heartbeat and translate replication
loops (``heartbeat``), and anti-entropy and the resize's data motion
(``syncer``). Nodes talk over HTTP or HTTPS with the binary wire codec
(``server/wire.py``); each node's executor may run its shards over a
mesh of its own devices."""

from pilosa_tpu_torch.parallel.mesh import MeshContext, ShardPlacement  # noqa: F401
