"""gRPC wire modules: the generated ``autoscaler_pb2`` (byte for byte the
JAX package's, so both speak one protocol) and the reference wire codec
``refcompat``. Both import ``grpc``/``google.protobuf``; import them only
where a gRPC binding is asked for."""
