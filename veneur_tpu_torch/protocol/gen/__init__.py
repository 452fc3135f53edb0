"""protoc output for protocol/dogstatsd_grpc.proto and
protocol/health.proto: byte-identical copies of the reference
package's generated modules."""
