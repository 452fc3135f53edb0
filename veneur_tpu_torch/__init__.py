"""PyTorch/CUDA port of veneur-tpu: DogStatsD aggregation on an NVIDIA GPU.

The layout mirrors the JAX package ``veneur_tpu`` module for module, so
each counterpart is easy to find; the JAX package is the reference the
port is tested against.  This package imports ``torch`` and numpy and
nothing of JAX or of ``veneur_tpu``: what it needs from the reference's
host-side modules it carries as its own copy.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``; without CUDA it raises unless the caller asked for
``"cpu"`` (see ``resolve_device``).  On the card the t-digest cluster
merge runs as a hand-written CUDA kernel (``csrc/cluster_merge.cu``);
on the CPU its plain PyTorch version runs instead.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on: exactly what the caller
    asked for.  A CUDA request without a usable card raises — there is
    no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
