"""Columnar batch shape: parsed DogStatsD lines as struct-of-arrays.

``ParsedBatch`` is the column set ``MetricTable.ingest_columns``
consumes; ``ColumnarParser`` fills it with the native batch parser
(``vtpu_parse_batch``, ``veneur_tpu_torch/native``) over a whole buffer
of newline-separated lines.  The server parses into columns only on
the multi-reader split path (``tpu_multi_reader_fused: false``);
otherwise ``MetricTable.ingest_buffer`` or a reader's ``ReaderShard``
parses, probes and combines in one native pass.  Only novel series,
events, service checks and malformed lines touch per-line Python
(``protocol.dogstatsd``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from veneur_tpu_torch import native

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


class ColumnarParser:
    """Reusable parse buffers around the native batch parser.  Not
    thread-safe: one parser per thread."""

    def __init__(self, max_lines: int = 1 << 16):
        self._lib = native.load()
        self.max_lines = max_lines
        self._alloc(max_lines)

    def _alloc(self, n: int) -> None:
        self._key = np.empty(n, np.uint64)
        self._type = np.empty(n, np.uint8)
        self._val = np.empty(n, np.float64)
        self._member = np.empty(n, np.uint64)
        self._wt = np.empty(n, np.float32)
        self._scope = np.empty(n, np.uint8)
        self._loff = np.empty(n, np.int64)
        self._llen = np.empty(n, np.int32)

    def parse(self, buf: bytes, copy: bool = True) -> ParsedBatch:
        """Parse a newline-separated buffer.  With ``copy=False`` the
        columns are views into this parser's scratch, valid only until
        its next ``parse``."""
        raw = np.frombuffer(buf, np.uint8)
        while True:
            # the native side returns -(lines needed) when the scratch
            # is too small; grow to the next power of two and retry
            n = self._lib.vtpu_parse_batch(
                raw.ctypes.data_as(native.u8p), len(buf),
                native.ptr(self._key, ctypes.c_uint64),
                native.ptr(self._type, ctypes.c_uint8),
                native.ptr(self._val, ctypes.c_double),
                native.ptr(self._member, ctypes.c_uint64),
                native.ptr(self._wt, ctypes.c_float),
                native.ptr(self._scope, ctypes.c_uint8),
                native.ptr(self._loff, ctypes.c_int64),
                native.ptr(self._llen, ctypes.c_int32),
                self.max_lines)
            if n >= 0:
                break
            self.max_lines = 1 << (-int(n) - 1).bit_length()
            self._alloc(self.max_lines)

        def own(a):
            return a[:n].copy() if copy else a[:n]
        return ParsedBatch(
            buf=buf, n=int(n),
            key_hash=own(self._key), type_code=own(self._type),
            value=own(self._val), member_hash=own(self._member),
            weight=own(self._wt), scope=own(self._scope),
            line_off=own(self._loff), line_len=own(self._llen))
