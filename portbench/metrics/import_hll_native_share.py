"""The share of the gRPC import's HLL sketches that the program folded
in its native pass rather than handing to its per-item codec, in %:
its flush records' ``counts["import.hll_native"]`` over those and
``counts["import.hll_codec"]``, summed over the window's flushes
(``veneur_tpu_torch/core/server.py``).  A program without the counts
reads as None."""

_KEYS = ("import.hll_native", "import.hll_codec")


def read(ctx):
    counts = [getattr(r, "counts", None) or {} for r in ctx.flush_records]
    if not any(k in c for c in counts for k in _KEYS):
        return None
    native, codec = (sum(c.get(k, 0) for c in counts) for k in _KEYS)
    if native + codec == 0:
        return None
    return 100.0 * native / (native + codec)
