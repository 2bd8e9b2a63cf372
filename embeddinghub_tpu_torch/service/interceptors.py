"""Server-side gRPC interceptor of the port's server: request-id
propagation and an INTERNAL backstop.

The counterpart of the JAX package's ``featurestore/interceptors.py`` for
the one server the port has.  Every RPC gets an ``x-request-id`` (the
caller's, or a new one) in its trailing metadata; an exception a handler
does not turn into a status itself leaves as INTERNAL with a log line
instead of UNKNOWN.  ``context.abort`` passes through untouched.
"""

from __future__ import annotations

import logging
import uuid

import grpc

REQUEST_ID_KEY = "x-request-id"
LOGGER = logging.getLogger("embeddinghub_tpu_torch.service")


def _is_grpc_abort(e: Exception) -> bool:
    """grpcio's ``context.abort`` raises a bare ``Exception()`` with no
    args to unwind the handler; that one must propagate untouched."""
    return type(e) is Exception and not e.args


def _tag(context) -> None:
    md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
    rid = md.get(REQUEST_ID_KEY) or uuid.uuid4().hex
    context.set_trailing_metadata(((REQUEST_ID_KEY, rid),))


def _internal(context, method: str, e: Exception) -> None:
    if _is_grpc_abort(e):
        raise e
    LOGGER.error("rpc_internal_error method=%s error=%s: %s", method,
                 type(e).__name__, e)
    context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")


def _wrap(fn, method: str):
    def inner(request_or_iterator, context):
        _tag(context)
        try:
            return fn(request_or_iterator, context)
        except Exception as e:  # noqa: BLE001 - the INTERNAL backstop
            _internal(context, method, e)

    return inner


def _wrap_stream(fn, method: str):
    """Streaming responses: errors can surface mid-iteration, after the
    handler returned its generator, so the iteration is wrapped too."""
    def inner(request_or_iterator, context):
        _tag(context)
        try:
            yield from fn(request_or_iterator, context)
        except Exception as e:  # noqa: BLE001
            _internal(context, method, e)

    return inner


class ServerInterceptor(grpc.ServerInterceptor):
    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        for kind, wrap, factory in (
            ("unary_unary", _wrap, grpc.unary_unary_rpc_method_handler),
            ("unary_stream", _wrap_stream, grpc.unary_stream_rpc_method_handler),
            ("stream_unary", _wrap, grpc.stream_unary_rpc_method_handler),
            ("stream_stream", _wrap_stream, grpc.stream_stream_rpc_method_handler),
        ):
            fn = getattr(handler, kind)
            if fn:
                return factory(wrap(fn, method),
                               request_deserializer=handler.request_deserializer,
                               response_serializer=handler.response_serializer)
        return handler


def make_server(executor, **kw) -> grpc.Server:
    """``grpc.server`` with :class:`ServerInterceptor` last in the chain."""
    interceptors = list(kw.pop("interceptors", ())) + [ServerInterceptor()]
    return grpc.server(executor, interceptors=interceptors, **kw)
