"""Typed serving errors (counterpart of
``deeplearning4j_tpu/serving/errors.py``; the subset the predict path
raises). The HTTP layer maps them to status codes: QueueFullError ->
429, DeadlineExceededError -> 504, ModelNotFoundError -> 404,
ServerClosedError -> 503. ``retry_after_s`` becomes a Retry-After
header on 429/503."""

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ModelNotFoundError", "ServerClosedError"]


class ServingError(RuntimeError):
    """Base class for serving-layer failures; ``retry_after_s`` is the
    raiser's backoff hint."""

    retry_after_s = None

    def __init__(self, *args, retry_after_s=None):
        super().__init__(*args)
        if retry_after_s is not None:
            self.retry_after_s = float(retry_after_s)


class QueueFullError(ServingError):
    """Admission control rejected the request: the bounded queue is at
    its limit. Back off and retry (429)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before its batch was served; the
    work was never started (504)."""


class ModelNotFoundError(ServingError, KeyError):
    """No model registered under the requested name/version (404)."""

    def __str__(self):   # KeyError quotes its message; keep it plain
        return ServingError.__str__(self)


class ServerClosedError(ServingError):
    """The scheduler/server is draining or shut down (503)."""
