"""Columnar batch shape: parsed DogStatsD lines as struct-of-arrays.

``ParsedBatch`` is the column set ``MetricTable.ingest_columns``
consumes.  The reference package fills it with its native C++ batch
parser; this package carries no native library, so a batch is built by
the caller (tests, benchmarks, an external parser) and the table takes
its pure-numpy ingest path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# type codes shared with the reference's native parser — metric classes
# 0..4, markers >= 250 for the per-line slow path
CODE_COUNTER = 0
CODE_GAUGE = 1
CODE_TIMER = 2
CODE_HISTOGRAM = 3
CODE_SET = 4
CODE_EVENT = 250
CODE_SERVICE_CHECK = 251
CODE_SHED = 252
CODE_ERROR = 255

SCOPE_CODES = ("", "local", "global")  # index = wire scope code


@dataclass
class ParsedBatch:
    """Struct-of-arrays view over one parsed buffer.  ``buf`` backs the
    offset columns; slices of it re-parse via the slow path.

    Only ``type_code``, ``line_off`` and ``line_len`` are defined for
    EVERY entry.  For metric lines (type_code <= CODE_SET) ``key_hash``,
    ``weight`` and ``scope`` are defined; ``value`` only for non-sets
    and ``member_hash`` only for sets."""
    buf: bytes
    n: int
    key_hash: np.ndarray    # u64[n] (metric lines)
    type_code: np.ndarray   # u8[n]
    value: np.ndarray       # f64[n] (metric lines except sets)
    member_hash: np.ndarray  # u64[n] (sets only)
    weight: np.ndarray      # f32[n] = 1/rate (metric lines)
    scope: np.ndarray       # u8[n] (metric lines)
    line_off: np.ndarray    # i64[n]
    line_len: np.ndarray    # i32[n]

    def line(self, i: int) -> bytes:
        o = int(self.line_off[i])
        return self.buf[o:o + int(self.line_len[i])]
