"""embeddinghub_tpu_torch -- the PyTorch + CUDA port of embeddinghub_tpu.

The same vector database as ``embeddinghub_tpu``, for one NVIDIA H100:
the Hub -> Space -> Version store, the wire-compatible gRPC server, the
flat engine and the graph engine's exact bulk build and search, with the two
Pallas kernels of the JAX package rewritten as hand-written CUDA for Hopper
(``csrc/k1_scan.cu``, ``csrc/k2_scan.cu``).  The layout mirrors the JAX
package, so each counterpart sits at the same path:

    ops/      distances, the fused top-k kernels and their plain twins, the
              graph's beam walk and neighbor selection
    index/    FlatIndex (float32 arena and its bf16 mirror on a torch.device)
              and HNSWIndex (built once, then served)
    store/    EmbeddingHub -> Space -> Version, with WAL + snapshots
    service/  gRPC server, its copies of the reference's proto stubs and
              QueryBatcher, and its request-id interceptor
    sdk/      gRPC client, offline Index and REPL
    utils/    environment configuration and gRPC channels

The package imports torch and numpy, never jax, and nothing of
``embeddinghub_tpu``: what it shares with that package (the proto, the
batcher, the configuration, the channels) it keeps as its own copy.  The
server and the client (which need grpc) are imported only where they are
used.  Entry points put the store on ``"cuda"`` unless told ``device=``
otherwise.
"""

__version__ = "0.1.0"
