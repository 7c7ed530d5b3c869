"""Typed serving errors (counterpart of
``deeplearning4j_tpu/serving/errors.py``; the subset the predict,
generate and fleet paths raise). The HTTP layer maps them to status
codes: QueueFullError (and KVPagePoolExhaustedError) -> 429,
DeadlineExceededError -> 504, ModelNotFoundError -> 404,
ServerClosedError, CircuitOpenError and NoReplicaAvailableError -> 503,
KVLeaseError -> 422, ReplicaGoneError -> 502 (at the router).
``retry_after_s`` becomes a Retry-After header on 429/503."""

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "ModelNotFoundError", "ServerClosedError", "CircuitOpenError",
           "ReplicaGoneError", "NoReplicaAvailableError",
           "KVPagePoolExhaustedError", "ReplicaBootError", "KVLeaseError",
           "KVLeaseCorruptError", "KVLeaseVersionError",
           "UpstreamBodyError"]


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


class KVPagePoolExhaustedError(QueueFullError):
    """The paged KV allocator has no free pages for this reservation
    (models/paged_kv.py), with a ``retry_after_s`` hint scaled to the
    shortfall: 429 + Retry-After for callers driving sessions directly.
    ``ContinuousBatcher`` absorbs it at slotting time (the request stays
    pending with its deadline enforced, since active decodes free pages
    on their own); a request whose worst case exceeds the WHOLE pool is
    a client error instead (ValueError at submit)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before its batch was served; the
    work was never started (504)."""


class ModelNotFoundError(ServingError, KeyError):
    """No model registered under the requested name/version (404)."""

    def __str__(self):   # KeyError quotes its message; keep it plain
        return ServingError.__str__(self)


class ServerClosedError(ServingError):
    """The scheduler/server is draining or shut down (503)."""


class CircuitOpenError(ServingError):
    """The backend's circuit breaker is open after repeated worker
    crashes: the request is shed immediately instead of being queued
    into a crash-looping worker. Retry after the breaker's cooldown
    (HTTP maps this to 503)."""


class ReplicaGoneError(ServingError):
    """The replica pinned to this request (a session-affine
    ``/v1/generate`` stream) died mid-flight. The router does not fail
    the stream over silently (its decode state lived on the dead
    replica): the client gets this typed error with the trace id and
    restarts the stream (502)."""


class NoReplicaAvailableError(ServingError):
    """Every replica of the fleet is dead, ejected or draining: the
    router has nowhere to send the request (503; ``retry_after_s`` is
    the soonest a replica may be readmitted)."""


class KVLeaseError(ServingError):
    """A serialized KV lease (``PagedSlotSession.export_lease``) could
    not be imported: the blob itself is bad, so sending it elsewhere
    cannot help."""


class KVLeaseCorruptError(KVLeaseError):
    """The lease blob failed its integrity checks (bad magic, truncated
    payload, CRC mismatch)."""


class KVLeaseVersionError(KVLeaseError):
    """The lease blob's schema does not match this session: wire version
    skew, another ``page_size``, or per-layer pool shapes of another
    model."""


class ReplicaBootError(ServingError):
    """A fleet replica failed to boot (scale-up or replace successor):
    it raised before its listener opened, or the chaos
    ``serving.replica.boot`` site fired ``boot_fail``.
    ``ReplicaFleet.grow()`` retries boots with bounded exponential
    backoff and raises this once the retry budget is spent."""


class UpstreamBodyError(ServingError):
    """A replica's response arrived but its body cannot be trusted: the
    headers were cut before a framing header (no Content-Length on a
    2xx), or a JSON-typed body failed to parse. The router treats it as
    a mid-exchange network error (retryable for idempotent work, counts
    toward ejection) instead of relaying it to the client."""
