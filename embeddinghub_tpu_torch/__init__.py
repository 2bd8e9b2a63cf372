"""embeddinghub_tpu_torch -- the PyTorch + CUDA port of embeddinghub_tpu.

The same vector database as ``embeddinghub_tpu``, for one NVIDIA H100:
the Hub -> Space -> Version store, the wire-compatible gRPC server and the
flat engine, with the two Pallas kernels of the JAX package rewritten as
hand-written CUDA for Hopper (``csrc/fused_topk.cu``).  The layout mirrors
the JAX package, so each counterpart sits at the same path:

    ops/      distances, the fused top-k kernels and their plain twins
    index/    FlatIndex (float32 arena on a torch.device)
    store/    EmbeddingHub -> Space -> Version, in memory
    service/  gRPC server on the reference's proto stubs and QueryBatcher

The package imports torch and numpy, never jax.  The server module (which
needs grpc) is imported only where it is used.
"""

__version__ = "0.1.0"
