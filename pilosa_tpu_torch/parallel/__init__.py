"""The static cluster: shard placement (``hashing``), topology and
failure bookkeeping (``cluster``), the node-to-node HTTP client
(``client``), the queued cluster-message broadcast (``broadcast``), the
coordinator's fan-out with replica failover (``cluster_executor``) and
the heartbeat and translate replication loops (``heartbeat``), after
the JAX package's ``parallel/``. Each node is one process with one
card; nodes talk over HTTP or HTTPS with the binary wire codec
(``server/wire.py``)."""
