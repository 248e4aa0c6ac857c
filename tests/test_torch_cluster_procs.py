"""The port's dynamic cluster as ``cli server`` processes, after
``tests/test_cluster_procs.py``: two processes that name each other in
``cluster_peers`` (replica 2) and a third that names only a seed in
``cluster_seeds``, each with a short ``anti_entropy_interval``. The
third joins through its seed once it listens; imports through the first
reach every owner; one process is frozen with SIGSTOP while an import
lands (its legs time out and are left to anti-entropy), then resumed,
and the anti-entropy loops converge every owner's block digests with
every Count exact through every node. SIGTERM stops each with 0."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SW = 1 << 20
N_SHARDS = 4
ROWS = 3


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _req(uri, method, path, body=None, timeout=30):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    r = urllib.request.Request(uri + path, data=data, method=method)
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _start(toml):
    """A ``cli server -c toml`` process, its log beside the file."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")}
    with open(str(toml) + ".log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-c",
             str(toml), "--device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.DEVNULL, stderr=log)


def _until(pred, what, timeout=60):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            if pred():
                return
        except (urllib.error.URLError, OSError, KeyError) as e:
            last = e
        time.sleep(0.2)
    raise AssertionError(f"{what} (last error {last!r})")


def _batch(rows_cols):
    return {"rowIDs": [r for r, _ in rows_cols],
            "columnIDs": [c for _, c in rows_cols]}


def test_seed_join_and_anti_entropy_across_processes(tmp_path):
    ports = _free_ports(3)
    uris = [f"http://127.0.0.1:{p}" for p in ports]
    common = ("cluster_replicas = 2\nanti_entropy_interval = 0.5\n"
              "heartbeat_interval = 0.5\n"
              "[cluster]\nrpc_timeout_s = 2.0\nfanout_deadline_s = 10.0\n")
    peers = f'cluster_peers = ["{uris[0]}", "{uris[1]}"]\n'
    tomls = []
    for i, port in enumerate(ports):
        member = peers if i < 2 else f'cluster_seeds = ["{uris[0]}"]\n'
        path = tmp_path / f"node{i}.toml"
        path.write_text(f'bind = "127.0.0.1:{port}"\n' + member + common)
        tomls.append(path)
    procs = [_start(tomls[0]), _start(tomls[1])]
    try:
        for uri in uris[:2]:
            _until(lambda: _req(uri, "GET", "/status", timeout=2),
                   f"{uri} never answered", timeout=120)
        procs.append(_start(tomls[2]))
        _until(lambda: len(_req(uris[0], "GET", "/status")["nodes"]) == 3
               and all(_req(u, "GET", "/status")["state"] == "NORMAL"
                       for u in uris), "the seed join never completed",
               timeout=120)
        status = _req(uris[2], "GET", "/status")
        assert {n["uri"] for n in status["nodes"]} == set(uris)
        _req(uris[0], "POST", "/index/ci", {"options": {}})
        _req(uris[0], "POST", "/index/ci/field/cf", {"options": {}})
        landed = [(c % ROWS, (c % N_SHARDS) * SW + c) for c in range(120)]
        _req(uris[0], "POST", "/index/ci/field/cf/import", _batch(landed))
        q = " ".join(f"Count(Row(cf={r}))" for r in range(ROWS)).encode()

        def want():
            return [sum(1 for r, _ in landed if r == row)
                    for row in range(ROWS)]

        for uri in uris:
            assert _req(uri, "POST", "/index/ci/query", q)["results"] \
                == want(), uri
        # Node 1 frozen while an import lands: its legs time out.
        procs[1].send_signal(signal.SIGSTOP)
        try:
            more = [(c % ROWS, (c % N_SHARDS) * SW + c)
                    for c in range(500, 700)]
            _req(uris[0], "POST", "/index/ci/field/cf/import", _batch(more),
                 timeout=60)
            landed += more
        finally:
            procs[1].send_signal(signal.SIGCONT)

        def converged():
            for uri in uris:
                if _req(uri, "POST", "/index/ci/query", q)["results"] \
                        != want():
                    return False
            for shard in range(N_SHARDS):
                owners = _req(uris[0], "GET", "/internal/fragment/nodes"
                                              f"?index=ci&shard={shard}")
                sums = {json.dumps(_req(
                    o["uri"], "GET", "/internal/fragment/blocks?index=ci"
                    f"&field=cf&view=standard&shard={shard}")["blocks"])
                    for o in owners}
                if len(owners) != 2 or len(sums) != 1:
                    return False
            return True

        _until(converged, "the replicas never converged", timeout=90)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)
                proc.send_signal(signal.SIGTERM)
        rcs = []
        for proc in procs:
            try:
                rcs.append(proc.wait(timeout=60))
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs.append(proc.wait())
    assert rcs == [0, 0, 0], [open(str(t) + ".log").read()[-2000:]
                              for t in tomls]
