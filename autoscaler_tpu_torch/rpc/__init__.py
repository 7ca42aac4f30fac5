"""gRPC wire modules: the generated ``autoscaler_pb2`` and ``fleet_pb2``
(the JAX package's, so both speak one protocol), the reference wire codec
``refcompat``, and the simulation sidecar ``service`` (servicer, ``serve``,
``drain_server`` and the failover client; ``python -m
autoscaler_tpu_torch.rpc`` launches it). All import ``grpc``/
``google.protobuf``; import them only where a gRPC binding is asked for."""
