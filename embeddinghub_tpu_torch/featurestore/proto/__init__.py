import sys as _sys

from embeddinghub_tpu_torch.featurestore.proto import serving_pb2  # noqa: F401

_sys.modules.setdefault("serving_pb2", serving_pb2)

from embeddinghub_tpu_torch.featurestore.proto import serving_pb2_grpc  # noqa: F401,E402
