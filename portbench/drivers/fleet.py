"""Driver of fleet cells (traffic ``kind: fleet``): a global importing
every local's forward wire by gRPC.

A separate process (``fleet_sender.py``) sends every local's wire by
gRPC ``SendMetrics`` to the server's import listener; once all are
acknowledged, the flush.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from pbench import harness
from pbench.spec import PORTBENCH

PROTOCOL = "grpc-import"
WORK_METRIC = "import_items_per_s"


class SenderProcess:
    """``fleet_sender.py`` as a child process, spoken to by lines."""

    def __init__(self, cell, seed: int, scale: int):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(PORTBENCH, "fleet_sender.py"),
             cell.traffic_path, str(seed), str(scale)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(PORTBENCH))

    def ask(self, line: str | None, want: str) -> list[str]:
        if line is not None:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()
        got = self.proc.stdout.readline().split()
        if not got or got[0] != want:
            raise RuntimeError(f"fleet sender said {got!r}, wanted {want}")
        return got[1:]

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_setup0: float, scale: int = 1, build_dir: str | None = None,
        hooks=None) -> harness.RunOutput:
    from veneur_tpu_torch.forward import grpc_forward
    sender = SenderProcess(cell, seed, scale)
    srv = imp = None
    try:
        srv, sink = harness.make_server(cell, device, build_dir)
        imp = grpc_forward.ImportServer(srv, "127.0.0.1:0")
        imp.start()
        srv.grpc_servers.append(imp)
        if hooks:
            hooks(srv, sink)
        items, cents, nbytes, gen_s, worker_s = sender.ask(None, "ready")
        sender.ask(f"port {imp.port}", "connected")

        def interval(n: int):
            t0 = time.monotonic()
            with harness.span(trace, "import"):
                _, ok, failed, acked = sender.ask(f"go {n} {t0!r}", "done")
            iv = harness.Interval(n, time.monotonic() - t0, 0.0, 0.0,
                                  int(acked), int(ok) + int(failed),
                                  int(failed), False)
            return iv, iv.failed == 0

        out = harness.window(srv, sink, interval, PROTOCOL, seed, seconds,
                             trace, t_setup0)
        lat = json.loads(" ".join(sender.ask("stop", "latencies")))
        n_win = {iv.n for iv in out.intervals}
        out.latencies = [s for n, s in lat if n in n_win]
        out.info.update({"items": int(items), "centroids": int(cents),
                         "wire_bytes": int(nbytes),
                         "wire_build_s": float(gen_s),
                         "wire_worker_s": float(worker_s)})
    finally:
        sender.close()
        if srv is not None:
            srv.shutdown()
    return out


def expected(cell, out, seed: int, scale: int):
    """The reference's interval, worked out again from the seed."""
    from reference import expected as ref
    srv = cell.config["server"]
    return ref.fleet_expected(cell.traffic, seed, srv["percentiles"],
                              srv["aggregates"], scale)


def control_pair(cell, seed: int, scale: int):
    """(what the reference expects, what the control flushes): the
    control's global holds a random half of each local's samples."""
    from reference import expected as ref
    srv = cell.config["server"]
    ps, aggs = srv["percentiles"], srv["aggregates"]
    return (ref.fleet_expected(cell.traffic, seed, ps, aggs, scale),
            ref.fleet_expected(cell.traffic, seed, ps, aggs, scale,
                               keep=0.5))
