"""Frozen copies of the forward wire's generated protobuf modules
(``forward.proto``, ``metric.proto``, ``tdigest.proto``: package
``forwardrpc`` / ``metricpb`` / ``tdigest``).  They are byte-identical
to the protoc output the wire was defined with, so they share one set
of message classes with any other identical copy in the interpreter.
The benchmark's tests decode its hand-built wires with them."""
