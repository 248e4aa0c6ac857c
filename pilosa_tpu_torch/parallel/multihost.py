"""Multi-process dryrun over ``torch.distributed``, after the JAX
package's ``parallel/multihost.py``.

``python -m pilosa_tpu_torch.parallel.multihost --backend {gloo,nccl}
--device {cpu,cuda} [--processes N]`` spawns N child processes (2 by
default) that join one process group at ``tcp://127.0.0.1:<free port>``.
Each child derives the same global ``[8, 8, 512]`` banks ``a`` and ``b``
from ``default_rng(123)``, as the JAX dryrun does, and holds only its
own block of the shard axis, as a local ``MeshContext`` of slices of
its device (4 a process with two processes). It computes the per-row
``|a ∧ b|`` with ``bank_row_counts`` on each part, reduces within the
process through the mesh's psum, then across processes with
``all_reduce``, and checks the result exactly against numpy. A child
that hangs is killed at the timeout.

``init_process_group`` is also the server's counterpart of
``jax.distributed.initialize`` (``cli server`` with
``jax_num_processes > 1``): NCCL for a CUDA device, gloo for the CPU,
chosen by the device and never by what happens to be loaded.

Nothing runs at import.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

ROWS = 8
SHARDS = 8
WORDS = 512
SEED = 123
TIMEOUT_S = 300.0


def backend_for(device: str) -> str:
    """The process group's backend for a device type."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(coordinator: str, world_size: int, rank: int,
                       device: str, backend: Optional[str] = None) -> None:
    """Join the process group at ``tcp://<coordinator>`` (host:port) as
    ``rank`` of ``world_size``."""
    import torch.distributed as dist
    if rank < 0 or rank >= world_size:
        raise ValueError(f"process id {rank} outside [0, {world_size}): "
                         f"set jax_process_id for each process")
    dist.init_process_group(backend=backend or backend_for(device),
                            init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank)


def banks():
    """The global banks ``a`` and ``b``, as uint32 ``[ROWS, SHARDS,
    WORDS]``, the same in every process."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, 2**32, (ROWS, SHARDS, WORDS), dtype=np.uint32)
    b = rng.integers(0, 2**32, (ROWS, SHARDS, WORDS), dtype=np.uint32)
    return a, b


def child(rank: int, world: int, coordinator: str, backend: str,
          device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel.mesh import MeshContext

    init_process_group(coordinator, world, rank, device, backend)
    try:
        a, b = banks()
        if SHARDS % world:
            raise ValueError(f"{SHARDS} shards do not split over {world} "
                             f"processes")
        local = SHARDS // world
        lo = rank * local
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        # This process's block of the shard axis, as a mesh of slices
        # of its device (one part a local shard, at most 4).
        parts = min(4, local)
        mesh = MeshContext([dev] * parts)
        ga = mesh.put_bank(a[:, lo:lo + local])
        gb = mesh.put_bank(b[:, lo:lo + local])
        inter = torch.bitwise_and(ga, gb)
        got = kernels.bank_row_counts(inter)  # psum over the local mesh
        dist.all_reduce(got)                  # then across processes
        got = got.cpu().numpy()
        want = np.unpackbits((a & b).view(np.uint8), axis=-1).reshape(
            ROWS, -1).sum(axis=1).astype(np.int64)
        if not np.array_equal(got, want):
            raise AssertionError(f"rank {rank}: {got} != {want}")
        print(f"multihost child {rank}/{world} ({backend}, {dev}, "
              f"{parts} local parts): OK counts={got[:3].tolist()}...",
              flush=True)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(backend: str, device: str, processes: int = 2,
        timeout: float = TIMEOUT_S) -> int:
    """Spawn the children and wait for them; returns 0 when every child
    checked out. A child still running at ``timeout`` is killed."""
    coordinator = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    # Each child writes into its own pipe, and the parent relays the
    # children's lines in rank order once they have ended: children that
    # share one stream can interleave their writes within a line.
    procs: List[subprocess.Popen] = [subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.parallel.multihost",
         "--child", str(i), "--processes", str(processes),
         "--coordinator", coordinator, "--backend", backend,
         "--device", device], env=env, stdout=subprocess.PIPE, text=True)
        for i in range(processes)]
    deadline = time.monotonic() + timeout
    outs: List[str] = []
    rc = 0
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            rc |= 1 if p.returncode else 0
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            rc |= 1
        outs.append(out or "")
    for out in outs:
        sys.stdout.write(out)
    sys.stdout.flush()
    print(f"multihost dryrun: {'OK' if rc == 0 else 'FAILED'} "
          f"({processes} processes, {backend}, {device})", flush=True)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="pilosa_tpu_torch.parallel.multihost")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--coordinator", default="")
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.processes, args.coordinator, args.backend,
              args.device)
        return 0
    return run(args.backend, args.device, args.processes, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
