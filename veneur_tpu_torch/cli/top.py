"""vtop: one-screen fleet health view over /debug/signals.

Port of ``veneur_tpu/cli/top.py``; it speaks the same protocols
through the port's own protocol, trace and discovery modules.

Usage: python -m veneur_tpu_torch.cli.top --nodes host:port,host:port
       python -m veneur_tpu_torch.cli.top --consul veneur --watch 5
       python -m veneur_tpu_torch.cli.top --nodes ... --json

Scrapes every node's ``/debug/signals?summary=1`` (the one-row shape
observe/signals.py serves: latest value + EWMA rate per signal) in
one parallel round and renders the fleet table an operator reads
first during an incident: per-node pressure, ledger balance,
breaker/spool map, ingest and shed rates.  ``--json`` emits the raw
merged summaries for scripting — the same shape the server's
``/debug/cluster`` endpoint serves for its own peers.

The node list is static (``--nodes``) or Consul-discovered
(``--consul <service>``, reusing forward/discovery.py's client).
Scraper threads are named ``vtop-scrape-*`` and joined every round —
the conftest thread-leak guard pins that.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

SCRAPE_TIMEOUT = 2.0

# fleet-table columns: header, width, and how to compute the cell
# from a /debug/signals?summary=1 payload (values = latest row,
# rates = EWMA per-second)
_BREAKER_GLYPH = {0: ".", 1: "?", 2: "!"}


def scrape_node(addr: str) -> dict:
    """One node's signal summary; an ``error`` dict instead of an
    exception so a dead node renders as a row, not a traceback."""
    url = addr if "://" in addr else f"http://{addr}"
    url = url.rstrip("/") + "/debug/signals?summary=1"
    try:
        with urllib.request.urlopen(url,
                                    timeout=SCRAPE_TIMEOUT) as resp:
            out = json.loads(resp.read().decode())
        out["addr"] = addr
        return out
    except Exception as e:
        return {"addr": addr, "error": f"{type(e).__name__}: {e}",
                "signals": {}, "rates": {}}


def scrape_fleet(nodes: list[str]) -> list[dict]:
    """One scrape round: every node in parallel, one thread per node,
    all joined before returning (no thread outlives the round)."""
    results: list[dict | None] = [None] * len(nodes)

    def _one(i: int, addr: str) -> None:
        results[i] = scrape_node(addr)

    threads = [threading.Thread(target=_one, args=(i, addr),
                                name=f"vtop-scrape-{i}", daemon=True)
               for i, addr in enumerate(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SCRAPE_TIMEOUT + 1.0)
    return [r if r is not None
            else {"addr": nodes[i], "error": "scrape timed out",
                  "signals": {}, "rates": {}}
            for i, r in enumerate(results)]


def discover_nodes(consul_url: str, service: str) -> list[str]:
    from veneur_tpu_torch.forward.discovery import ConsulDiscoverer
    return ConsulDiscoverer(consul_url).get_destinations_for_service(
        service)


def _fmt_rate(v) -> str:
    v = v or 0.0
    if abs(v) >= 1e6:
        return f"{v / 1e6:.1f}M"
    if abs(v) >= 1e3:
        return f"{v / 1e3:.1f}k"
    return f"{v:.1f}"


def _breaker_cell(sig: dict) -> str:
    """closed/half-open/open counts as e.g. ``3/0/1``."""
    return (f"{int(sig.get('breaker.closed') or 0)}/"
            f"{int(sig.get('breaker.half_open') or 0)}/"
            f"{int(sig.get('breaker.open') or 0)}")


def render_table(rows: list[dict]) -> str:
    """The one-screen fleet table.  Columns: node, role, pressure
    level+score, ledger balance verdict, breaker map
    (closed/half/open), spool backlog, ingest + shed EWMA rates."""
    header = (f"{'NODE':<28} {'ROLE':<7} {'PRS':>3} {'SCORE':>6} "
              f"{'LEDGER':>7} {'BRK c/h/o':>9} {'SPOOL':>7} "
              f"{'INGEST/s':>9} {'SHED/s':>7} {'ROWS':>5}")
    lines = [header, "-" * len(header)]
    for r in rows:
        name = r.get("node") or r.get("addr", "?")
        addr = r.get("addr", "")
        label = name if name else addr
        if addr and name and addr not in (name,):
            label = f"{name}({addr})"
        if r.get("error"):
            lines.append(f"{label[:28]:<28} {'-':<7} "
                         f"DOWN: {r['error']}")
            continue
        sig = r.get("signals") or {}
        rates = r.get("rates") or {}
        role = r.get("role", "?")
        if role == "proxy":
            balanced = bool(sig.get("ledger.balanced", 1))
            ingest = rates.get("route.routed", 0.0)
            shed = rates.get("route.busy_dropped", 0.0)
            spool = int(sig.get("dest.queued") or 0)
            prs, score = "-", "-"
        else:
            balanced = bool(sig.get("ledger.balanced", 1))
            ingest = rates.get("ingest.metrics_processed", 0.0)
            shed = rates.get("shed.total", 0.0)
            spool = int(sig.get("spool.queued_items") or 0)
            prs = str(int(sig.get("pressure.level") or 0))
            score = f"{(sig.get('pressure.score') or 0.0):.2f}"
        imb = int(sig.get("ledger.imbalanced_total") or 0)
        ledger = "ok" if balanced and not imb else (
            f"IMB:{imb}" if imb else "OWED")
        lines.append(
            f"{label[:28]:<28} {role:<7} {prs:>3} {score:>6} "
            f"{ledger:>7} {_breaker_cell(sig):>9} {spool:>7} "
            f"{_fmt_rate(ingest):>9} {_fmt_rate(shed):>7} "
            f"{int(r.get('rows') or 0):>5}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vtop", description="fleet health over /debug/signals")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--nodes",
                       help="comma-separated host:port list")
    group.add_argument("--consul",
                       help="consul service name to discover nodes")
    ap.add_argument("--consul-url", default="http://127.0.0.1:8500",
                    help="consul base url (with --consul)")
    ap.add_argument("--json", action="store_true",
                    help="emit raw merged summaries as JSON")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                    help="re-scrape every SEC seconds until ^C")
    args = ap.parse_args(argv)

    def _nodes() -> list[str]:
        if args.nodes:
            return [n.strip() for n in args.nodes.split(",")
                    if n.strip()]
        return discover_nodes(args.consul_url, args.consul)

    try:
        while True:
            rows = scrape_fleet(_nodes())
            if args.json:
                print(json.dumps({"scraped_unix": time.time(),
                                  "nodes": rows}, indent=1))
            else:
                print(render_table(rows))
            if not args.watch:
                return 0 if all(not r.get("error")
                                for r in rows) else 1
            time.sleep(args.watch)
            if not args.json:
                print()
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
