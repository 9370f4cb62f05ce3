"""Typed apiserver errors, the port's copy of ``tpushare/k8s/errors.py``:
the client raises :class:`ConflictError` on HTTP 409 and the device
plugin retries on the type, not on the message."""

from __future__ import annotations


class ApiError(Exception):
    """An apiserver request failed."""

    def __init__(self, status: int, reason: str = "", body: str = ""):
        self.status = status
        self.reason = reason
        self.body = body
        super().__init__(f"apiserver error {status}: {reason or body}")


class ConflictError(ApiError):
    """HTTP 409: optimistic-concurrency conflict on update."""

    def __init__(self, reason: str = "", body: str = ""):
        super().__init__(409, reason or "Conflict", body)


class NotFoundError(ApiError):
    """HTTP 404: the object does not exist."""

    def __init__(self, reason: str = "", body: str = ""):
        super().__init__(404, reason or "NotFound", body)
