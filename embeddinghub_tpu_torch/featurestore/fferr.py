"""Typed error taxonomy.

Rebuild of reference ``fferr/`` (~40 typed constructors carrying gRPC
status + context maps, ``fferr/errors.go``).  Python exceptions with a
``code`` (gRPC status name) and a context dict, grouped by domain.
"""

from __future__ import annotations


class FFError(Exception):
    code = "INTERNAL"

    def __init__(self, message: str, **context):
        super().__init__(message)
        self.context = dict(context)

    def with_context(self, **kv) -> "FFError":
        self.context.update(kv)
        return self

    def grpc_code(self):
        """The grpc.StatusCode this error maps to on the wire (the
        reference's fferr errors carry a grpc status the interceptors
        serialize, fferr/errors.go)."""
        import grpc

        return getattr(grpc.StatusCode, self.code, grpc.StatusCode.INTERNAL)


class InternalError(FFError):
    """Unrecoverable internal invariant violation (reference
    fferr.NewInternalError)."""

    code = "INTERNAL"


# ---- resources / metadata


class ResourceNotFoundError(FFError):
    code = "NOT_FOUND"

    def __init__(self, rtype: str, name: str, variant: str | None = None):
        ident = f"{rtype}/{name}" + (f"/{variant}" if variant else "")
        super().__init__(f"resource not found: {ident}", type=rtype, name=name)


class ResourceExistsError(FFError):
    code = "ALREADY_EXISTS"

    def __init__(self, rtype: str, name: str, variant: str | None = None):
        ident = f"{rtype}/{name}" + (f"/{variant}" if variant else "")
        super().__init__(f"resource already exists: {ident}", type=rtype, name=name)


class ResourceChangedError(FFError):
    code = "FAILED_PRECONDITION"

    def __init__(self, rtype: str, name: str, variant: str, diff: str = ""):
        super().__init__(
            f"resource {rtype}/{name}/{variant} was re-registered with "
            f"different properties: {diff}",
            type=rtype,
            name=name,
            variant=variant,
        )


class InvalidResourceError(FFError):
    code = "INVALID_ARGUMENT"


class DependencyNotReadyError(FFError):
    code = "FAILED_PRECONDITION"


class DependencyFailedError(FFError):
    code = "ABORTED"


# ---- providers


class ProviderError(FFError):
    code = "INTERNAL"


class ProviderNotFoundError(FFError):
    code = "NOT_FOUND"

    def __init__(self, name: str):
        super().__init__(f"provider not found: {name}", provider=name)


class ProviderTypeError(FFError):
    code = "INVALID_ARGUMENT"

    def __init__(self, name: str, want: str):
        super().__init__(
            f"provider {name} cannot be used as {want}", provider=name, want=want
        )


class EntityNotFoundError(FFError):
    code = "NOT_FOUND"

    def __init__(self, feature: str, variant: str, entity: str):
        super().__init__(
            f"no value for entity {entity} in {feature}/{variant}",
            feature=feature,
            variant=variant,
            entity=entity,
        )


# ---- jobs / tasks


class JobError(FFError):
    code = "INTERNAL"


class JobAlreadyRunningError(FFError):
    code = "ABORTED"


class JobFailedError(JobError):
    def __init__(self, job_id: str, detail: str = ""):
        super().__init__(
            f"transform job {job_id} failed: {detail}", job_id=job_id
        )


class KeyAlreadyLockedError(FFError):
    code = "ABORTED"

    def __init__(self, key: str, owner: str = ""):
        super().__init__(f"key already locked: {key}", key=key, owner=owner)


class LockEmptyKeyError(FFError):
    code = "INVALID_ARGUMENT"

    def __init__(self):
        super().__init__("cannot lock an empty key")
