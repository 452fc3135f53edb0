"""protoc output for protocol/dogstatsd_grpc.proto,
protocol/health.proto and protocol/ssf.proto: byte-identical copies of
the reference package's generated modules."""
