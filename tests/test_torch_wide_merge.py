"""F2: cluster merges wider than the reference's 2048-lane bound.

The reference's table runs its Pallas kernel only where
``pallas_merge.supported(cap, K)`` holds and takes its XLA merge
elsewhere.  The port's ``cluster_merge`` makes the same decision
(``route``): on a CUDA tensor a supported shape launches the kernel on
its ``kernel`` route and a wider one on its ``wide`` route (a wider row
in shared memory), counted as ``cluster_merge.wide``.  Pins: the
decision against ``pallas_merge.supported`` over the capacities of the
compressions a config can ask for; a port server at
``tpu_compression: 300`` (capacity past 1,800 slots, so every full-width
timer merge is wide) against the JAX server on the same stream on the
CPU; and, on the card, the same server against a CPU port server.
Tolerances: percentiles rtol 2e-3 / atol 1e-3, the rest bit for bit.

The JAX package is imported inside the tests that compare with it, so
the card's test runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_wide_merge.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu_torch import observe
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import cluster_merge, tdigest

_DATA = {"interval": "60s", "hostname": "h", "tpu_counter_rows": 32,
         "tpu_gauge_rows": 32, "tpu_histo_rows": 32, "tpu_set_rows": 4,
         "tpu_compression": 300.0, "tpu_overload": False}


@pytest.mark.parametrize("compression", [20.0, 100.0, 168.0, 169.0,
                                         296.0, 300.0, 1000.0])
def test_route_is_the_references_supported_rule(compression):
    from veneur_tpu.ops import pallas_merge
    from veneur_tpu.ops import tdigest as jtd
    cap = tdigest.capacity_for(compression)
    assert cap == jtd.capacity_for(compression)
    for k in (1, 32, 64, 128, 256, 384, 512, 616, 1024, 1432, 1433,
              2048 - cap, 2049 - cap, cap):
        if k <= 0:
            continue
        want = "kernel" if pallas_merge.supported(cap, k) else "wide"
        assert cluster_merge.route(cap, k) == want, (cap, k)
        assert cluster_merge.supported(cap, k) == \
            pallas_merge.supported(cap, k)


def test_wide_cpu_merge_takes_the_plain_version_uncounted():
    """On the CPU every width runs the plain version, and no launch is
    counted."""
    cap = tdigest.capacity_for(300.0)
    rng = np.random.default_rng(3)
    m = torch.zeros((4, cap))
    w = torch.zeros((4, cap))
    bm = torch.from_numpy(rng.normal(100, 10, (4, 512)).astype(np.float32))
    bw = torch.ones((4, 512))
    kw = dict(delta=tdigest._SCALE_MULT * 300.0,
              tail_coeff=tdigest._TAIL_MULT * 300.0,
              tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
    launches = observe.REGISTRY.launches()
    om, ow = cluster_merge.cluster_merge(m, w, bm, bw, **kw)
    pm, pw = cluster_merge.cluster_merge_plain(m, w, bm, bw, **kw)
    assert torch.equal(om, pm) and torch.equal(ow, pw)
    assert float(ow.sum()) == 4 * 512
    assert observe.REGISTRY.launches() == launches


def _stream(seed: int = 9) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(12):
        lines = [f"wide{k}:{v:.4f}|ms".encode()
                 for v in rng.gamma(2.0, 30.0, 1500)]
        # datagrams under metric_max_length
        out += [b"\n".join(lines[i:i + 100])
                for i in range(0, len(lines), 100)]
    out.append(b"wide.hits:5|c\nwide.depth:3|g")
    return out


def _flush(srv) -> dict:
    try:
        for pkt in _stream():
            srv.handle_packet(pkt)
        return {(m.name, m.tags): m.value for m in srv.flush_once().metrics
                if not m.name.startswith("veneur.")}
    finally:
        srv.shutdown()


def _assert_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert any(k[0] == "wide0.99percentile" for k in got)
    for key, w in want.items():
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(got[key], w, rtol=2e-3, atol=1e-3,
                                       err_msg=str(key))
        else:
            assert got[key] == w, key


def test_compression_300_server_matches_jax():
    """The CPU twin of the card test: the port server's wide merges (the
    plain version) flush what the JAX server's XLA merge flushes."""
    from veneur_tpu.core.config import read_config as jread_config
    from veneur_tpu.core.server import Server as JServer
    got = _flush(Server(read_config(data=_DATA), device="cpu"))
    want = _flush(JServer(jread_config(data=_DATA)))
    _assert_close(got, want)


@pytest.mark.cuda
def test_compression_300_server_on_the_card():
    """On the card the full-width timer merges take the kernel's wide
    route: the server flushes (it raised before F2) what a CPU port
    server flushes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode")
    wide = observe.REGISTRY.launches().get("cluster_merge.wide", 0)
    got = _flush(Server(read_config(data=_DATA), device="cuda"))
    assert observe.REGISTRY.launches()["cluster_merge.wide"] > wide
    _assert_close(got, _flush(Server(read_config(data=_DATA),
                                     device="cpu")))
