"""Server entry point:

    python -m veneur_tpu_torch.cli.main -f config.yaml [--device cuda|cpu]

Runs until SIGINT or SIGTERM, then shuts the server down cleanly.  The
device defaults to ``cuda``; without a card the server refuses to start
unless ``--device cpu`` is given.

A replacement generation started with ``VENEUR_TPU_SOCK_CLOAKED``
(``statsd.udp.<address>.<reader>=<fd>``, ``http=<fd>``) and those fds
passed down (``pass_fds``) adopts its predecessor's bound listeners, so
datagrams parked in the kernel across the restart are read; with
``tpu_checkpoint_dir`` set it takes the next incarnation id and replays
the predecessor's surviving checkpoint segments at start.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="veneur_tpu_torch")
    ap.add_argument("-f", dest="config", required=True,
                    help="YAML config file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    cfg = read_config(args.config)
    srv = Server(cfg, device=args.device)
    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    srv.start()
    logging.getLogger("veneur_tpu_torch").info(
        "listening on %s with %d reader(s) each%s, http %s, grpc %s, "
        "device %s, %s", cfg.statsd_listen_addresses,
        max(1, cfg.num_readers),
        " (fused shards)" if cfg.num_readers > 1 and
        cfg.tpu_multi_reader_fused else "", srv.http_port,
        srv.grpc_ports, srv.device,
        f"local forwarding to {cfg.forward_address}" if cfg.is_local()
        else "global")
    logging.getLogger("veneur_tpu_torch").info(
        "statsd ports %s, incarnation %d, %d listener fd(s) adopted",
        srv.statsd_ports, srv.incarnation, srv.restarts_adopted)
    stop.wait()
    srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
