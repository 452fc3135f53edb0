"""On-demand device profile captures for /debug/pprof/device.

The port's counterpart of ``veneur_tpu/observe/profiler.py``, on
``torch.profiler``: an operator grabs N seconds of the process's CPU
and CUDA activity from a running server without a restart, the way
``/debug/pprof/profile?seconds=N`` grabs a cProfile sample.  The
profiler records the card's activity through CUPTI, which sees every
kernel of the process, so those launched through ctypes (the cluster
merge) appear beside torch's own.
The capture is written as a Chrome trace (``trace.json``) into a fresh
directory, and the response lists the artifact files.  Without a card
the capture records CPU activity only.
"""

from __future__ import annotations

import os
import tempfile
import time

MAX_SECONDS = 30.0


def capture_device_profile(seconds: float,
                           base_dir: str | None = None) -> dict:
    """Run torch.profiler for ``seconds`` (capped) and return
    ``{"dir": ..., "seconds": ..., "files": [{name, bytes}, ...]}``.

    The caller serializes (only one profiler per process); raised
    errors are the caller's to map onto an HTTP status.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    seconds = max(0.05, min(float(seconds), MAX_SECONDS))
    out_dir = tempfile.mkdtemp(prefix="veneur-device-profile-",
                               dir=base_dir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(seconds)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    files = []
    for root, _dirs, names in os.walk(out_dir):
        for name in names:
            path = os.path.join(root, name)
            files.append({
                "name": os.path.relpath(path, out_dir),
                "bytes": os.path.getsize(path)})
    return {"dir": out_dir, "seconds": seconds,
            "activities": [a.name for a in activities],
            "files": sorted(files, key=lambda f: f["name"])}
