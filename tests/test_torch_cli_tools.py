"""The port's CLI data tools (``import``, ``check``, ``inspect``,
``backup``, ``restore``, ``fold``) against the JAX package's, both run in
process through their ``main([...])`` on the CPU:

- one CSV set (a set field as ``row,col``, an int field as
  ``col,value``) through both packages' ``import -d``: the printed
  lines, the exports and every fragment file byte-equal;
- ``import --host`` into a port server and into a JAX server on
  loopback: the same messages and the same answers;
- ``check`` and ``inspect`` (with ``--verbose``) over the same files:
  the same output and exit codes, a torn tail and a corrupt file among
  them;
- ``fold``: byte-equal files, a torn tail refused without ``--force``
  and sidecarred with it, each package opening the other's folded
  directory to the same answers;
- ``backup`` and ``restore``: the same member names, the same refusals
  (a non-empty directory, a path leaving it, a symlink) and ``--force``.
"""

import os
import shutil
import tarfile
import threading

import numpy as np
import pytest

from pilosa_tpu.cli import main as jcli
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu_torch import Executor, Holder
from pilosa_tpu_torch.cli import main as tcli
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.server import API, serve

N_COLS = 4 * SHARD_WIDTH


def write_csvs(path, seed=0, n=30000):
    """cab.csv (``row,col``, three rows over four shards, a few
    duplicate pairs) and amount.csv (``col,value``, a column once,
    negative values among them)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, N_COLS, n)
    rows = rng.integers(0, 3, n)
    lines = [f"{r},{c}\n" for r, c in zip(rows, cols)]
    lines += lines[:50] + ["\n"]
    (path / "cab.csv").write_text("".join(lines))
    ucols = np.unique(cols)
    vals = rng.integers(-300, 5000, len(ucols))
    (path / "amount.csv").write_text(
        "".join(f"{c},{v}\n" for c, v in zip(ucols, vals)))
    return rows, cols, ucols, vals


def run(cli, argv, capsys):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def fragment_files(root):
    """{relative path: bytes} of every fragment file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        if os.sep + "fragments" not in dirpath + os.sep:
            continue
        for name in files:
            if name.isdigit():
                full = os.path.join(dirpath, name)
                with open(full, "rb") as f:
                    out[os.path.relpath(full, root)] = f.read()
    return out


def imports(cli, d, csvs, extra=()):
    return [
        ["import", "-d", str(d), "-i", "taxi", "-f", "cab",
         str(csvs / "cab.csv"), *extra],
        ["import", "-d", str(d), "-i", "taxi", "-f", "amount",
         "--field-type", "int", str(csvs / "amount.csv"), *extra],
    ]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(csv dir, JAX data dir, port data dir, printed lines) after both
    packages' local imports of the same CSVs."""
    base = tmp_path_factory.mktemp("cli")
    write_csvs(base)
    jdir, tdir = base / "jax", base / "port"
    printed = []
    for cli, d, extra in ((jcli, jdir, ()), (tcli, tdir, ("--device",
                                                           "cpu"))):
        lines = []
        for argv in imports(cli, d, base, extra):
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(argv) == 0
            lines.append(buf.getvalue())
        printed.append(lines)
    return base, jdir, tdir, printed


def test_local_import_matches_jax(capsys, dirs):
    base, jdir, tdir, printed = dirs
    assert printed[0] == printed[1]
    assert printed[1][0] == "imported 30050 records into taxi/cab\n"
    jf, tf = fragment_files(jdir), fragment_files(tdir)
    assert sorted(tf) == sorted(jf) and len(tf) >= 12
    for rel in jf:
        assert tf[rel] == jf[rel], rel
    for field in ("cab", "amount"):
        got = run(tcli, ["export", "-d", str(tdir), "-i", "taxi", "-f",
                         field, "--device", "cpu"], capsys)
        want = run(jcli, ["export", "-d", str(jdir), "-i", "taxi", "-f",
                          field], capsys)
        assert got == want
        # An int field's values are in its BSI view: its export (the
        # standard view) is empty in both packages.
        assert (got[1].count("\n") > 1000) == (field == "cab")


def test_local_import_answers_match_jax(dirs):
    """The imported directory answers Count, Sum, Min and Max as the
    JAX package's over its own import."""
    _, jdir, tdir, _ = dirs
    jh, th = JaxHolder(str(jdir)), Holder(str(tdir), device="cpu")
    jh.open()
    th.open()
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    for pql in ("Count(Row(cab=1))", "Count(Row(cab=0))",
                "Sum(field=amount)", "Sum(Row(cab=2), field=amount)",
                "Min(field=amount)", "Max(field=amount)",
                "Count(Row(amount > 1000))"):
        got = tex.execute("taxi", parse_string(pql))
        want = jex.execute("taxi", pql)
        assert repr(got) == repr(want) or got == want, pql
    jh.close()
    th.close()


def test_import_usage_errors_match_jax(tmp_path, capsys):
    (tmp_path / "x.csv").write_text("1,2\n")
    for argv in (["import", "-i", "i", "-f", "f", str(tmp_path / "x.csv")],):
        assert run(tcli, argv, capsys) == run(jcli, argv, capsys)
    assert run(tcli, argv, capsys)[0] == 2


def _serve_port():
    api = API(Holder(device="cpu"))
    srv = serve(api, "localhost", 0, background=True)
    return api, srv, f"http://localhost:{srv.server_address[1]}"


def test_remote_import_matches_jax(tmp_path, capsys, monkeypatch):
    """``import --host`` posts the CSV in REMOTE_IMPORT_BATCH batches
    (lowered here so several posts go out) into a port server and a JAX
    server: the same message and the same counts and sums."""
    rows, cols, ucols, vals = write_csvs(tmp_path, seed=1, n=5000)
    monkeypatch.setattr(tcli, "REMOTE_IMPORT_BATCH", 700)
    monkeypatch.setattr(jcli, "REMOTE_IMPORT_BATCH", 700)
    papi, psrv, purl = _serve_port()
    jh = JaxHolder(str(tmp_path / "jsrv"))
    jh.open()
    japi = JaxAPI(jh)
    jsrv = jax_serve(japi, "localhost", 0, background=True)
    jurl = f"http://localhost:{jsrv.server_address[1]}"
    try:
        for field, extra, csv in (("cab", [], "cab.csv"),
                                  ("amount", ["--field-type", "int"],
                                   "amount.csv")):
            outs = []
            for cli, url in ((tcli, purl), (jcli, jurl)):
                rc, out, err = run(cli, ["import", "--host", url, "-i", "r",
                                         "-f", field, *extra,
                                         str(tmp_path / csv)], capsys)
                assert rc == 0, err
                if cli is tcli:
                    # The port also logs the import's own seconds.
                    n = out.split()[1]
                    assert f" INFO import: {n} records in " in err, err
                outs.append(out.replace(url, "URL"))
            assert outs[0] == outs[1]
        for pql in ("Count(Row(cab=0))", "Count(Row(cab=2))",
                    "Sum(field=amount)", "Min(field=amount)"):
            got = papi.query("r", pql)
            want = japi.query("r", pql)
            assert str(got) == str(want), pql
        want_count = len(np.unique(cols[rows == 0]))
        assert papi.query("r", "Count(Row(cab=0))") == [want_count] or \
            str(want_count) in str(papi.query("r", "Count(Row(cab=0))"))
    finally:
        for srv in (psrv, jsrv):
            srv.shutdown()
            srv.server_close()
        jh.close()


def _norm(text, d):
    return text.replace(str(d), "<D>")


def _all_files(d):
    return sorted(os.path.join(dp, n) for dp, _, fs in os.walk(d)
                  for n in fs if n.isdigit())


def test_check_and_inspect_match_jax(capsys, dirs, tmp_path):
    """The same output and exit code over every fragment file, then over
    a copy with its last record cut (TORN TAIL) and one with a bad
    header (CORRUPT)."""
    _, jdir, tdir, _ = dirs
    files = _all_files(tdir)
    for argv in (["check"], ["inspect"], ["inspect", "--verbose"]):
        got = run(tcli, argv + files, capsys)
        want = run(jcli, argv + files, capsys)
        assert got == want
        assert got[0] == 0 and got[1].count("\n") >= len(files)
    torn = tmp_path / "torn"
    data = open(files[0], "rb").read()
    torn.write_bytes(data[:-5])
    corrupt = tmp_path / "corrupt"
    corrupt.write_bytes(b"\x01\x02" + data[2:100])
    got = run(tcli, ["check", str(torn), str(corrupt), files[1]], capsys)
    want = run(jcli, ["check", str(torn), str(corrupt), files[1]], capsys)
    assert got[0] == want[0] == 1
    assert got[1] == want[1]
    assert "TORN TAIL" in got[2] and "CORRUPT" in got[2]
    assert [ln.split(":")[0] for ln in got[2].splitlines()] == \
        [ln.split(":")[0] for ln in want[2].splitlines()]
    assert got[2].splitlines()[0] == want[2].splitlines()[0]
    argv = ["inspect", "--verbose", str(torn)]
    assert run(tcli, argv, capsys) == run(jcli, argv, capsys)


def test_file_tools_start_without_torch(tmp_path):
    """``check`` and ``fold`` read and write fragment files in a process
    that never imports torch (its import costs the tools seconds)."""
    import subprocess
    import sys

    from pilosa_tpu_torch.storage.roaring import serialize_positions
    path = tmp_path / "0"
    path.write_bytes(serialize_positions(np.array(
        [1, 70000, SHARD_WIDTH + 5], np.uint64)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "from pilosa_tpu_torch.cli import main\n"
        "p = sys.argv[1]\n"
        "rcs = [main.main(a + [p]) for a in (['check'], ['fold'])]\n"
        "print('RESULT', rcs, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", script, str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RESULT [0, 0] False" in out.stdout, out.stdout
    assert ": ok (3 bits" in out.stdout


def test_fold_matches_jax(capsys, dirs, tmp_path):
    """Folding copies of the imported directories gives byte-equal
    files; a torn tail is refused (exit 1) until ``--force``, which
    appends it to the ``.torn`` sidecar first; a fold of a folded file
    changes nothing."""
    _, jdir, tdir, _ = dirs
    copies = []
    for name in ("j", "t"):
        d = tmp_path / name
        shutil.copytree(tdir, d)
        f = _all_files(d)[0]
        data = open(f, "rb").read()
        with open(f, "wb") as fh:
            fh.write(data[:-3])
        copies.append(d)
    outs = []
    for cli, d in ((jcli, copies[0]), (tcli, copies[1])):
        files = _all_files(d)
        first = run(cli, ["fold"] + files, capsys)
        forced = run(cli, ["fold", "--force"] + files, capsys)
        again = run(cli, ["fold"] + files, capsys)
        outs.append([(rc, _norm(o, d), _norm(e, d))
                     for rc, o, e in (first, forced, again)])
    assert outs[0] == outs[1]
    assert outs[1][0][0] == 1 and "re-run with --force" in outs[1][0][2]
    assert outs[1][1][0] == 0 and "sidecarred" in outs[1][1][2]
    jf, tf = fragment_files(copies[0]), fragment_files(copies[1])
    assert jf == tf
    sides = []
    for d in copies:
        torn = [os.path.join(dp, n) for dp, _, fs in os.walk(d)
                for n in fs if n.endswith((".torn", ".folding"))]
        assert len(torn) == 1 and torn[0].endswith(".torn")
        sides.append(open(torn[0], "rb").read())
    assert sides[0] == sides[1] and len(sides[1]) > 0
    rc, out, _ = run(tcli, ["check"] + _all_files(copies[1]), capsys)
    assert rc == 0 and all("opN=0" in ln for ln in out.splitlines())


def test_each_package_opens_the_others_folded_directory(capsys, dirs,
                                                        tmp_path):
    _, jdir, tdir, _ = dirs
    j, t = tmp_path / "j", tmp_path / "t"
    shutil.copytree(jdir, j)
    shutil.copytree(tdir, t)
    assert run(jcli, ["fold"] + _all_files(j), capsys)[0] == 0
    assert run(tcli, ["fold"] + _all_files(t), capsys)[0] == 0
    assert fragment_files(j) == fragment_files(t)
    jh, th = JaxHolder(str(t)), Holder(str(j), device="cpu")
    jh.open()
    th.open()
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    for pql in ("Count(Row(cab=0))", "Sum(field=amount)",
                "TopN(cab)", "Count(Row(amount < 0))"):
        got = tex.execute("taxi", parse_string(pql))
        want = jex.execute("taxi", pql)
        assert str(got) == str(want), pql
    jh.close()
    th.close()


def test_backup_and_restore_match_jax(capsys, dirs, tmp_path):
    """The same members (``.torn`` sidecars and the output itself left
    out), the same messages, the refusal of a non-empty directory and
    ``--force``, which replaces it."""
    _, _, tdir, _ = dirs
    src = tmp_path / "src"
    shutil.copytree(tdir, src)
    (src / "taxi" / "x.torn").write_bytes(b"zz")
    tars = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        out = src / f"{name}.tar.gz"  # inside the directory: skipped
        rc, msg, err = run(cli, ["backup", "-d", str(src), "-o", str(out)],
                           capsys)
        assert rc == 0, err
        tars[name] = (out, _norm(msg, src).replace(f"{name}.tar.gz", "T"))
        shutil.move(str(out), tmp_path / out.name)
        tars[name] = (tmp_path / out.name, tars[name][1])
    assert tars["j"][1] == tars["t"][1]
    names = [sorted(tarfile.open(p).getnames()) for p, _ in tars.values()]
    assert names[0] == names[1] and not [n for n in names[1]
                                         if n.endswith((".torn", ".gz"))]
    for name, cli in (("j", jcli), ("t", tcli)):
        dest = tmp_path / f"restored_{name}"
        first = run(cli, ["restore", "-d", str(dest), "-i",
                          str(tars["t"][0])], capsys)
        again = run(cli, ["restore", "-d", str(dest), "-i",
                          str(tars["t"][0])], capsys)
        forced = run(cli, ["restore", "-d", str(dest), "-i",
                           str(tars["j"][0]), "--force"], capsys)
        tars[name + "_runs"] = [(rc, _norm(o, dest), _norm(e, dest))
                                for rc, o, e in (first, again, forced)]
        assert fragment_files(dest) == fragment_files(tdir)
    assert tars["j_runs"] == tars["t_runs"]
    assert [r[0] for r in tars["t_runs"]] == [0, 1, 0]
    assert "refusing to restore" in tars["t_runs"][1][2]
    missing = ["backup", "-d", str(tmp_path / "nope"), "-o",
               str(tmp_path / "n.tgz")]
    assert run(tcli, missing, capsys) == run(jcli, missing, capsys)


@pytest.mark.parametrize("member", ["traversal", "symlink"])
def test_restore_refuses_unsafe_members_as_jax(tmp_path, capsys, member):
    bad = tmp_path / "bad.tar"
    payload = tmp_path / "p"
    payload.write_bytes(b"x")
    with tarfile.open(bad, "w") as tar:
        if member == "traversal":
            tar.add(payload, arcname="../escape")
        else:
            info = tarfile.TarInfo("link")
            info.type = tarfile.SYMTYPE
            info.linkname = "/etc/passwd"
            tar.addfile(info)
    outs = []
    for name, cli in (("j", jcli), ("t", tcli)):
        dest = tmp_path / name
        rc, out, err = run(cli, ["restore", "-d", str(dest), "-i",
                                 str(bad)], capsys)
        outs.append((rc, out, err))
        assert not os.listdir(dest)
    assert outs[0] == outs[1] and outs[1][0] == 1
    assert "unsafe" in outs[1][2]
    assert not (tmp_path / "escape").exists()


def test_server_logs_through_the_logger_and_posts_diagnostics(tmp_path):
    """``cli server`` with diagnostics and the runtime monitor at short
    intervals: its log lines come from ``utils/logger``, a report
    reaches a loopback listener with the JAX payload's keys, and
    ``/metrics`` carries the monitor's gauges."""
    import json
    import subprocess
    import sys
    import time
    import urllib.request
    from http.server import BaseHTTPRequestHandler, HTTPServer

    received = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    sink = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    cfg = tmp_path / "s.toml"
    cfg.write_text(
        'bind = "127.0.0.1:0"\nmetric_poll_interval = 0.2\n'
        f'[diagnostics]\nurl = "http://127.0.0.1:{sink.server_port}/d"\n'
        'interval = 0.2\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PILOSA_TPU_RESULT_CACHE="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-c",
         str(cfg), "--platform", "cpu", "--verbose"], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "device=cpu" in line, line
        url = line.split()[4]
        deadline = time.time() + 60
        metrics = ""
        while time.time() < deadline and (
                not received or "openFiles" not in metrics):
            time.sleep(0.1)
            metrics = urllib.request.urlopen(url + "/metrics").read().decode()
        want = set(__import__("pilosa_tpu.utils.diagnostics",
                              fromlist=["x"]).DiagnosticsCollector(
            holder=JaxHolder(str(tmp_path / "h"))).payload())
        assert received and set(received[0]) == want
        assert received[0]["NumIndexes"] == 0
        for gauge in ("threads", "heapInuse", "openFiles", "gcGen0",
                      "tailDroppedBytes", "garbageCollection"):
            assert gauge in metrics, gauge
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
        sink.shutdown()
        sink.server_close()
    err = proc.stderr.read()
    assert " INFO pilosa-tpu server: data=(memory) bind=127.0.0.1:0" in err
