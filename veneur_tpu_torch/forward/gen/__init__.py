"""protoc output for forward/protos/*.proto: byte-identical copies of
the reference package's generated modules, so both share one set of
message classes when imported into one interpreter."""
