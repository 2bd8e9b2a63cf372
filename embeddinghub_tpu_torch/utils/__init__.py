"""Process configuration and gRPC channels of the port (jax-free)."""
