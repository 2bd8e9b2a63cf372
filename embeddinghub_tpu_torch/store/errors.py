"""Typed store errors: the twin of ``embeddinghub_tpu/store/errors.py``
(same classes, same ``grpc_code``s), which cannot be imported without jax.

Mirrors the reference's result-style error taxonomy
(``embeddingstore/error.h``, ``version.h:52-67`` —
``UpdateImmutableVersionError``) as Python exceptions, and borrows the
"typed constructors carrying context" idea from Featureform's ``fferr``
package (``fferr/errors.go``).
"""

from __future__ import annotations


class EmbeddingHubError(Exception):
    """Base class for all store errors."""

    grpc_code = "INTERNAL"

    def __init__(self, message: str, **context):
        super().__init__(message)
        self.context = context


class SpaceNotFoundError(EmbeddingHubError):
    grpc_code = "NOT_FOUND"

    def __init__(self, space: str):
        super().__init__(f"space not found: {space}", space=space)


class VersionNotFoundError(EmbeddingHubError):
    grpc_code = "NOT_FOUND"

    def __init__(self, space: str, version: str):
        super().__init__(
            f"version not found: {space}/{version}", space=space, version=version
        )


class SpaceAlreadyExistsError(EmbeddingHubError):
    grpc_code = "ALREADY_EXISTS"

    def __init__(self, space: str):
        super().__init__(f"space already exists: {space}", space=space)


class KeyNotFoundError(EmbeddingHubError):
    grpc_code = "NOT_FOUND"

    def __init__(self, space: str, key: str):
        super().__init__(f"key not found: {key} in space {space}", space=space, key=key)


class ImmutableVersionError(EmbeddingHubError):
    """Raised on writes to a frozen version.

    The reference surfaces this as gRPC FAILED_PRECONDITION, which the
    SDK converts to TypeError (``embeddinghub.py:117-121``,
    ``server.cc``'s use of ``UpdateImmutableVersionError``).
    """

    grpc_code = "FAILED_PRECONDITION"

    def __init__(self, space: str, version: str = "initial"):
        super().__init__(
            f"cannot update immutable version: {space}/{version}",
            space=space,
            version=version,
        )


class DimensionMismatchError(EmbeddingHubError):
    grpc_code = "INVALID_ARGUMENT"

    def __init__(self, expected: int, got: int):
        super().__init__(
            f"embedding dimension mismatch: expected {expected}, got {got}",
            expected=expected,
            got=got,
        )


class InvalidArgumentError(EmbeddingHubError):
    grpc_code = "INVALID_ARGUMENT"
