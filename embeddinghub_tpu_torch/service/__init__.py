"""gRPC service: import ``embeddinghub_tpu_torch.service.server`` (needs grpc)."""
