"""Generic gRPC span sink (reference sinks/grpsink, 802 LoC): streams
every span to a remote service implementing
``/grpsink.SpanSink/SendSpan`` — the protocol Falconer speaks.

Resilience model matches the reference's conn-state machinery (most
of grpsink.go): a connectivity watch tracks the channel state
(grpsink.go:81-90 WaitForStateChange loop), spans arriving while the
channel is DOWN are dropped instantly instead of blocking a span
worker on a doomed RPC (the dial's reconnect backoff is the channel's
own), error logs are limited to one per state transition
(grpsink.go:118-134 loggedSinceTransition), and sends are
future-based so a slow/hung target never stalls the worker pool —
at most ``inflight_cap`` RPCs ride concurrently, beyond which spans
drop-and-count.

Port of ``veneur_tpu/sinks/grpsink.py``.
"""

from __future__ import annotations

import logging
import threading

from veneur_tpu_torch.protocol.gen import grpsink_pb2

try:
    import grpc
except ImportError:  # pragma: no cover
    grpc = None

log = logging.getLogger("veneur_tpu_torch.sinks")

_METHOD = "/grpsink.SpanSink/SendSpan"


class GRPCSpanSink:
    name = "grpsink"

    def __init__(self, target: str, timeout: float = 5.0,
                 name: str = "grpsink", inflight_cap: int = 128):
        if grpc is None:  # pragma: no cover
            raise RuntimeError("grpcio unavailable")
        self.name = name
        self.target = target
        self._timeout = timeout
        self._channel = grpc.insecure_channel(target)
        self._call = self._channel.unary_unary(
            _METHOD,
            request_serializer=lambda span: span.SerializeToString(),
            response_deserializer=grpsink_pb2.Empty.FromString)
        self.submitted = 0
        self.dropped = 0
        self.dropped_down = 0  # dropped instantly while channel DOWN
        self._lock = threading.Lock()
        self._settled = threading.Condition(self._lock)
        self._inflight = 0
        self._inflight_cap = inflight_cap
        self._state = grpc.ChannelConnectivity.IDLE
        self._logged_since_transition = False

    def start(self) -> None:
        # connectivity watch (reference Start's state goroutine,
        # grpsink.go:77-91): the callback fires on every transition;
        # try_to_connect makes the channel actually dial so a dead
        # target is OBSERVED as TRANSIENT_FAILURE instead of idling
        self._channel.subscribe(self._on_state, try_to_connect=True)

    def _on_state(self, state) -> None:
        self._state = state
        self._logged_since_transition = False

    def _log_once(self, msg: str, *args) -> None:
        """One log per state transition (grpsink.go:118-134): enough
        of an indicator without log spew while the target is down."""
        with self._lock:
            if self._logged_since_transition:
                return
            self._logged_since_transition = True
        log.warning(msg + " (target=%s state=%s)", *args,
                    self.target, self._state)

    def ingest(self, span) -> None:
        down = self._state in (
            grpc.ChannelConnectivity.TRANSIENT_FAILURE,
            grpc.ChannelConnectivity.SHUTDOWN)
        if down:
            # instant drop while the channel is down — the channel's
            # own backoff governs the redial; a doomed RPC would hold
            # a span worker for up to the full timeout
            with self._lock:
                self.dropped += 1
                self.dropped_down += 1
            self._log_once("%s span dropped: channel down", self.name)
            return
        with self._lock:
            at_cap = self._inflight >= self._inflight_cap
            if at_cap:
                self.dropped += 1
            else:
                self._inflight += 1
        if at_cap:
            # log AFTER releasing the lock — _log_once takes it too
            self._log_once("%s span dropped: RPC backlog at cap %d",
                           self.name, self._inflight_cap)
            return
        try:
            fut = self._call.future(span, timeout=self._timeout)
        except Exception as e:  # dispatch itself failed
            with self._lock:
                self._inflight -= 1
                self.dropped += 1
            log.debug("%s span dispatch failed: %s", self.name, e)
            return
        fut.add_done_callback(self._done)

    def _done(self, fut) -> None:
        try:
            err = fut.exception()
        except grpc.FutureCancelledError:
            err = "cancelled"
        with self._lock:
            self._inflight -= 1
            if err is None:
                self.submitted += 1
            else:
                self.dropped += 1
            self._settled.notify_all()
        if err is not None:
            self._log_once("%s span send failed: %s", self.name, err)

    def flush(self) -> None:
        """Sync point: wait (bounded) for in-flight RPCs to settle, so
        the flush-interval counters reflect what actually happened —
        the role of the reference Flush's sent/drop report
        (grpsink.go:141-158)."""
        with self._settled:
            self._settled.wait_for(lambda: self._inflight == 0,
                                   timeout=self._timeout)

    def close(self) -> None:
        self._channel.unsubscribe(self._on_state)
        self._channel.close()

    def stop(self) -> None:
        """Server shutdown: close the channel (its connectivity watch
        and poller threads end with it)."""
        self.close()


class FalconerSpanSink(GRPCSpanSink):
    """Falconer is the grpsink protocol under its product name
    (reference sinks/falconer/falconer.go: a 13-line wrapper)."""

    def __init__(self, target: str, timeout: float = 5.0):
        super().__init__(target, timeout=timeout, name="falconer")


class GRPCSpanSinkServer:
    """Loopback test server implementing the SpanSink service — the
    role of the reference's MockSpanSinkServer (grpsink_test.go:20)."""

    def __init__(self, address: str = "127.0.0.1:0"):
        from concurrent import futures as cf
        self.spans = []
        self._grpc = grpc.server(cf.ThreadPoolExecutor(max_workers=2))
        handler = grpc.method_handlers_generic_handler(
            "grpsink.SpanSink",
            {"SendSpan": grpc.unary_unary_rpc_method_handler(
                self._send,
                request_deserializer=lambda b: b,
                response_serializer=(
                    grpsink_pb2.Empty.SerializeToString))})
        self._grpc.add_generic_rpc_handlers((handler,))
        self.port = self._grpc.add_insecure_port(address)

    def _send(self, request, context):
        from veneur_tpu_torch.protocol.gen import ssf_pb2
        self.spans.append(ssf_pb2.SSFSpan.FromString(request))
        return grpsink_pb2.Empty()

    def start(self):
        self._grpc.start()

    def stop(self):
        self._grpc.stop(0.2)
