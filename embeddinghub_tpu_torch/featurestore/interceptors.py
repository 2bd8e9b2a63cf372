"""Server-side gRPC interceptor: request-id propagation + uniform
error mapping.

Reference ``helpers/interceptors/interceptors.go:20-35`` (the
UnaryServerErrorInterceptor every service main installs) and the api
gateway's per-request request-ID logging (``api/api.go:86-99``).  The
servicers keep their precise per-RPC status mapping; this interceptor
is the uniform backstop — an *uncaught* ``fferr.FFError`` still leaves
the process as its declared status code instead of UNKNOWN, anything
else becomes INTERNAL with a structured log line, and the
``x-request-id`` metadata (minted when absent) binds to the logging
contextvar for the duration of the call.
"""

from __future__ import annotations

import grpc

from embeddinghub_tpu_torch.featurestore import fferr
from embeddinghub_tpu_torch.featurestore.logging import (
    LOGGER,
    new_request_id,
    set_request_id,
)

REQUEST_ID_KEY = "x-request-id"


def _is_grpc_abort(e: Exception) -> bool:
    """grpcio's ``context.abort`` raises a bare ``Exception()`` with no
    args to unwind the handler; that one must propagate untouched."""
    return type(e) is Exception and not e.args


def _wrap(fn, method: str):
    def inner(request_or_iterator, context):
        md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
        rid = md.get(REQUEST_ID_KEY) or new_request_id()
        set_request_id(rid)
        context.set_trailing_metadata(((REQUEST_ID_KEY, rid),))
        try:
            return fn(request_or_iterator, context)
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        except Exception as e:  # noqa: BLE001 — uniform INTERNAL backstop
            if _is_grpc_abort(e):
                raise
            LOGGER.error(
                "rpc_internal_error", method=method,
                error=f"{type(e).__name__}: {e}",
            )
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    return inner


def _wrap_stream(fn, method: str):
    """Streaming responses: errors can surface mid-iteration, after the
    handler returned its generator — wrap the iteration too."""
    def inner(request_or_iterator, context):
        md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
        rid = md.get(REQUEST_ID_KEY) or new_request_id()
        set_request_id(rid)
        context.set_trailing_metadata(((REQUEST_ID_KEY, rid),))
        try:
            yield from fn(request_or_iterator, context)
        except fferr.FFError as e:
            context.abort(e.grpc_code(), str(e))
        except Exception as e:  # noqa: BLE001
            if _is_grpc_abort(e):
                raise
            LOGGER.error(
                "rpc_internal_error", method=method,
                error=f"{type(e).__name__}: {e}",
            )
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    return inner


class ServerInterceptor(grpc.ServerInterceptor):
    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                _wrap(handler.unary_unary, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                _wrap_stream(handler.unary_stream, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.stream_unary:
            return grpc.stream_unary_rpc_method_handler(
                _wrap(handler.stream_unary, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.stream_stream:
            return grpc.stream_stream_rpc_method_handler(
                _wrap_stream(handler.stream_stream, method),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler


def make_server(executor, **kw) -> grpc.Server:
    """``grpc.server`` with the standard interceptor chain installed —
    what every reference service main does via its interceptor list."""
    interceptors = list(kw.pop("interceptors", ())) + [ServerInterceptor()]
    return grpc.server(executor, interceptors=interceptors, **kw)
