"""axiomhq/hyperloglog sketch bytes for the import tests: dense with any
base, sparse with its hashes in the tmpSet, the varint list or both,
the malformed forms the codec refuses, and MetricList wires of set
items carrying them.  Port modules only (no JAX package)."""

from __future__ import annotations

import numpy as np

from veneur_tpu_torch.forward import hll_codec
from veneur_tpu_torch.forward.gen import forward_pb2, metric_pb2
from veneur_tpu_torch.utils import hashing

M = hll_codec.M


def dense(regs: np.ndarray, b: int = 0, form: int = 0) -> bytes:
    """A dense sketch of ``regs`` (nibbles cut to 15) with base ``b``
    and sparse-flag byte ``form`` (any value but 1 reads dense)."""
    enc = bytearray(hll_codec.encode_dense(np.asarray(regs, np.uint8)))
    enc[2], enc[3] = b, form
    return bytes(enc)


def sparse_keys(members) -> list[int]:
    """Sorted encoded 32-bit sparse hashes of ``members``
    (sparse.go:15 encodeHash at p = 14, pp = 25)."""
    keys = set()
    for h in hashing.hash64(members):
        h = int(h)
        idx = (h >> (64 - 25)) & ((1 << 25) - 1)
        if (h >> (64 - 25)) & ((1 << 11) - 1) == 0:
            w = ((h << 25) & ((1 << 64) - 1)) | (1 << 24)
            keys.add((idx << 7) | ((64 - w.bit_length() + 1) << 1) | 1)
        else:
            keys.add(idx << 1)
    return sorted(keys)


def varints(listed) -> bytes:
    """The list's little 7-bit varint deltas (compressed.go:167)."""
    var = bytearray()
    last = 0
    for k in listed:
        x, last = (k - last) & 0xFFFFFFFF, k
        while x & ~0x7F:
            var.append((x & 0x7F) | 0x80)
            x >>= 7
        var.append(x)
    return bytes(var)


def sparse(tmpset, listed, count: int | None = None,
           var: bytes | None = None) -> bytes:
    """A sparse sketch: ``tmpset`` keys as be32 words, ``listed`` keys
    as the varint-delta list (``count`` and ``var`` override the list's
    declared count and bytes)."""
    body = bytearray([1, 14, 0, 1]) + len(tmpset).to_bytes(4, "big")
    for k in tmpset:
        body += int(k).to_bytes(4, "big")
    var = varints(listed) if var is None else var
    count = len(listed) if count is None else count
    last = int(listed[-1]) if len(listed) else 0
    body += count.to_bytes(4, "big") + last.to_bytes(4, "big")
    body += len(var).to_bytes(4, "big") + var
    return bytes(body)


def malformed(rng) -> dict[str, bytes]:
    """One sketch of each form the codec refuses, by name."""
    good = dense(rng.integers(0, 16, M))
    keys = sparse_keys([f"bad{i}".encode() for i in range(40)])
    whole = sparse(keys[:10], keys[10:])
    return {
        "short": b"\x01\x0e\x00",
        "empty": b"",
        "precision": bytes([1, 12]) + good[2:],
        "dense_size": good[:4] + (M // 4).to_bytes(4, "big") + good[8:],
        "dense_truncated": good[:-1],
        "sparse_header": whole[:6],
        "sparse_tmpset": whole[:8 + 4 * 10 - 2],
        "sparse_varbytes": whole[:-1],
        "varint_truncated": sparse([], keys[:3],
                                   var=varints(keys[:3])[:-1] + b"\x80"),
        "varint_short_count": sparse([], keys[:3], count=4),
        "zero_word_tmpset": sparse([keys[0], 5 << 12], []),
        "zero_word_list": sparse([], sorted([keys[0], 5 << 12])),
    }


def set_wire(items) -> bytes:
    """A serialized MetricList of set items, ``(name, sketch bytes)``
    each, in order."""
    ms = []
    for name, sk in items:
        m = metric_pb2.Metric(name=name, type=metric_pb2.Set)
        m.set.hyper_log_log = sk
        ms.append(m)
    return forward_pb2.MetricList(metrics=ms).SerializeToString()
