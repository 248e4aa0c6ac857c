"""``python -m pilosa_tpu_torch.cli server``: serve the port over HTTP.

    python -m pilosa_tpu_torch.cli server --bind HOST:PORT \\
        [--device cuda|cpu] [--no-coalescer] [--coalescer-window-ms MS]

The flags are the JAX package's (``pilosa_tpu/cli/main.py``). The holder
lives in memory (the port has no persistence yet), so there is no
``--data-dir`` and no TOML config. The server runs on CUDA unless
``--device cpu`` is given, and raises where there is no card. Port 0
binds a free port; the first line on stdout names the address served.
SIGTERM stops it like Ctrl-C: the coalescer drains what it admitted.
"""

from __future__ import annotations

import argparse
import signal
import sys


def _bind(bind: str):
    host, _, port = bind.rpartition(":")
    if not port.isdigit():
        raise SystemExit(f"--bind wants HOST:PORT, got {bind!r}")
    return host or "localhost", int(port)


def cmd_server(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.server.http import make_server

    host, port = _bind(args.bind)
    api = API(Holder(device=args.device))
    if not args.no_coalescer:
        api.coalescer = QueryCoalescer(
            api.executor, window_s=args.coalescer_window_ms / 1e3)
        api.coalescer.start()
    server = make_server(api, host, port)

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    addr = server.server_address
    coal = "off" if api.coalescer is None \
        else f"{args.coalescer_window_ms:g} ms"
    print(f"pilosa-tpu-torch server listening on http://{addr[0]}:{addr[1]}"
          f" device={api.holder.device} coalescer={coal}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if api.coalescer is not None:
            api.coalescer.stop()
        server.server_close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu-torch",
        description="The PyTorch/CUDA port of the bitmap index.")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("server", help="run the server")
    sp.add_argument("-b", "--bind", default="localhost:10101",
                    help="HOST:PORT to listen on (port 0: any free port)")
    sp.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu to run without "
                         "a card)")
    sp.add_argument("--no-coalescer", action="store_true",
                    help="serve every query on the direct path "
                         "(disable cross-request coalescing)")
    sp.add_argument("--coalescer-window-ms", type=float, default=1.5,
                    help="coalescer batching window in milliseconds")
    sp.set_defaults(fn=cmd_server)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
