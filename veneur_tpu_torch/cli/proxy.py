"""veneur-proxy binary (reference cmd/veneur-proxy/main.go:20).

Port of ``veneur_tpu/cli/proxy.py``::

    python -m veneur_tpu_torch.cli.proxy -f proxy.yaml

The proxy holds no device state, so it takes no ``--device``: the
globals behind it fold what it routes on their own cards.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from veneur_tpu_torch.core.config import ProxyConfig, read_config
from veneur_tpu_torch.core.proxy import ProxyServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="veneur-tpu-torch-proxy")
    ap.add_argument("-f", dest="config", required=True,
                    help="path to proxy config YAML")
    ap.add_argument("--validate-config", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    try:
        cfg = read_config(args.config, cls=ProxyConfig)
    except (ValueError, OSError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1
    if args.validate_config:
        print("config ok")
        return 0

    proxy = ProxyServer(cfg)
    proxy.start()
    stop = threading.Event()

    def _sig(*_):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    logging.getLogger("veneur_tpu_torch").info(
        "proxy serving: grpc=%s http=%s destinations=%d",
        cfg.grpc_address, cfg.http_address, len(proxy.ring.ring))
    stop.wait()
    proxy.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
