"""DogStatsD text for a ``DsdPlan``, built with numpy.

Each line is ``name:value|type|#tags``; 25 lines make a datagram and 64
datagrams a sweep, the newline-joined chunk a UDP reader hands to
``handle_packet_batch`` after one recvmmsg sweep.  Lines are laid out
as rows of a byte matrix padded with zero bytes, which the text never
holds, and the padding is squeezed out in one pass.
"""

from __future__ import annotations

import numpy as np

from pbench.plan import TYPE_CODE, DsdPlan, SeriesNames

_POW10 = np.array([10 ** k for k in range(1, 20)], dtype=np.uint64)


def ascii_digits(x: np.ndarray) -> np.ndarray:
    """Decimal digits of non-negative integers as ASCII, right-aligned
    in a zero-padded (n, width) matrix."""
    x = np.asarray(x, dtype=np.uint64)
    n_dig = 1 + np.searchsorted(_POW10, x, side="right")
    width = int(n_dig.max(initial=1))
    out = np.empty((len(x), width), np.uint8)
    y = x.copy()
    for col in range(width - 1, -1, -1):
        out[:, col] = (y % np.uint64(10)).astype(np.uint8) + 48
        y //= np.uint64(10)
    out[np.arange(width)[None, :] < (width - n_dig)[:, None]] = 0
    return out


def value_text(vals, prefix: bytes = b"") -> np.ndarray:
    """The value column: ``[prefix][-]digits[.decimals]``."""
    t = vals.text
    cols = []
    if prefix:
        cols.append(np.frombuffer(prefix, np.uint8)[None, :].repeat(len(t), 0))
    if (t < 0).any():
        cols.append(np.where(t < 0, 45, 0).astype(np.uint8)[:, None])
    a = np.abs(t)
    if vals.decimals:
        p = 10 ** vals.decimals
        cols.append(ascii_digits(a // p))
        cols.append(np.full((len(t), 1), 46, np.uint8))
        frac = ascii_digits(a % p + p)[:, -vals.decimals:]
        cols.append(frac)
    else:
        cols.append(ascii_digits(a))
    return np.concatenate(cols, axis=1)


def _rows(strings: list[bytes]) -> np.ndarray:
    w = max(len(s) for s in strings)
    out = np.zeros((len(strings), w), np.uint8)
    for i, s in enumerate(strings):
        out[i, :len(s)] = np.frombuffer(s, np.uint8)
    return out


def identity_rows(names: SeriesNames, type_code: bytes
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per series: the name with ``:`` and the ``|type|#tags`` tail."""
    heads = _rows([names.name(j).encode() + b":"
                   for j in range(names.n_series)])
    tails = _rows([b"|" + type_code + (b"|#" + ",".join(
        names.tags(j)).encode() if names.tags(j) else b"")
        for j in range(names.n_series)])
    return heads, tails


def _chunk(plan: DsdPlan, idents: list, lo: int, hi: int
           ) -> tuple[bytes, np.ndarray]:
    """Lines ``lo``..``hi`` as bytes (each ending in a newline) and
    their lengths."""
    parts = []
    for c, (heads, tails) in zip(plan.classes, idents):
        sel = np.nonzero((c.pos >= lo) & (c.pos < hi))[0]
        if not len(sel):
            continue
        s = c.series[sel]
        sub = type(c.values)(c.values.text[sel], c.values.decimals,
                             c.values.value[sel])
        val = value_text(sub, b"m" if c.type == "set" else b"")
        parts.append((c.pos[sel] - lo,
                      np.concatenate([heads[s], val, tails[s]], 1)))
    width = max(r.shape[1] for _, r in parts) + 1
    mat = np.zeros((hi - lo, width), np.uint8)
    for pos, rows in parts:
        mat[pos, :rows.shape[1]] = rows
        mat[pos, -1] = 10
    keep = mat != 0
    return mat[keep].tobytes(), keep.sum(1, dtype=np.int64)


def interval_sweeps(plan: DsdPlan, threads: int = 4
                    ) -> tuple[list[bytes], np.ndarray]:
    """The interval as sweeps (bytes, no trailing newline) and the
    number of lines in each, built in chunks of whole sweeps on
    ``threads`` threads (numpy releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    idents = [identity_rows(c.names, TYPE_CODE[c.type])
              for c in plan.classes]
    per = plan.lines_per_sweep
    n_chunks = max(1, min(4 * threads, plan.n_sweeps()))
    step = -(-plan.n_sweeps() // n_chunks) * per
    bounds = [(lo, min(lo + step, plan.n_lines))
              for lo in range(0, plan.n_lines, step)]
    with ThreadPoolExecutor(threads) as ex:
        chunks = list(ex.map(lambda b: _chunk(plan, idents, *b), bounds))
    sweeps = []
    counts = []
    for (lo, hi), (data, lens) in zip(bounds, chunks):
        ends = np.cumsum(lens)
        for a in range(0, hi - lo, per):
            b = min(a + per, hi - lo)
            start = int(ends[a - 1]) if a else 0
            sweeps.append(data[start:int(ends[b - 1]) - 1])
            counts.append(b - a)
    return sweeps, np.asarray(counts, np.int64)
