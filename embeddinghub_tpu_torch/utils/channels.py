"""gRPC channel factory with TLS options: the JAX package's
``utils/channels.py``, copied so the port imports nothing of that package.

Reference clients support hosted TLS endpoints via ``cert_path`` /
``insecure`` flags and the ``FEATUREFORM_CERT`` env var
(``client/src/featureform/register.py`` tls handling); this is the
shared analog for every client and server of the port.
"""

from __future__ import annotations

import os

import grpc

_OPTIONS = (("grpc.enable_http_proxy", 0),)


def make_channel(
    host: str,
    port: int,
    insecure: bool = True,
    cert_path: str | None = None,
) -> grpc.Channel:
    """Plaintext by default (parity with the reference's local mode and
    the C++ server's insecure creds, server.cc:249-268).  Pass
    ``insecure=False`` for system-CA TLS, or ``cert_path`` (or the
    EHTPU_CERT / FEATUREFORM_CERT env vars) for a self-signed root."""
    target = f"{host}:{port}"
    cert_path = (
        cert_path
        or os.environ.get("EHTPU_CERT")
        or os.environ.get("FEATUREFORM_CERT")
    )
    if insecure and not cert_path:
        return grpc.insecure_channel(target, options=_OPTIONS)
    root = None
    if cert_path:
        with open(cert_path, "rb") as f:
            root = f.read()
    creds = grpc.ssl_channel_credentials(root_certificates=root)
    return grpc.secure_channel(target, creds, options=_OPTIONS)


def add_server_port(
    server: grpc.Server,
    address: str,
    cert_path: str | None = None,
    key_path: str | None = None,
) -> int:
    """Bind ``address`` on ``server``: TLS when a cert/key PEM pair is
    provided (arguments or the EHTPU_SERVER_CERT / EHTPU_SERVER_KEY env
    vars), plaintext otherwise.  The reference serves TLS through its
    hosted ingress while local mode is insecure (server.cc:249-268,
    api/main StartHttpsServer); here every server binds TLS directly
    when configured."""
    cert_path = cert_path or os.environ.get("EHTPU_SERVER_CERT")
    key_path = key_path or os.environ.get("EHTPU_SERVER_KEY")
    if not (cert_path and key_path):
        return server.add_insecure_port(address)
    with open(key_path, "rb") as f:
        key = f.read()
    with open(cert_path, "rb") as f:
        crt = f.read()
    creds = grpc.ssl_server_credentials(((key, crt),))
    return server.add_secure_port(address, creds)
