"""Serving: registry, dynamic-batching scheduler, continuous batcher, HTTP
front end, the replica fleet behind its router, the fleet's control
loops (``autoscaler``, ``rollout``), the retrieval backend
(``retrieval_backend``) and the tensor-parallel predict backend
(``tp_backend``) (counterpart of ``deeplearning4j_tpu/serving``).

Submodules import lazily, as in the JAX package: ``serving.errors``
stays a dependency leaf, and importing the package pulls in neither
torch nor the HTTP stack until a component is used.
"""

_EXPORTS = {
    "ServingError": "errors",
    "QueueFullError": "errors",
    "DeadlineExceededError": "errors",
    "ModelNotFoundError": "errors",
    "ServerClosedError": "errors",
    "CircuitOpenError": "errors",
    "ReplicaGoneError": "errors",
    "NoReplicaAvailableError": "errors",
    "KVPagePoolExhaustedError": "errors",
    "ReplicaBootError": "errors",
    "CircuitBreaker": "lifecycle",
    "TierQueue": "lifecycle",
    "parse_tier": "tiers",
    "priced_retry_after_s": "tiers",
    "LatencyHistogram": "metrics",
    "EndpointMetrics": "metrics",
    "BatchOccupancy": "metrics",
    "StreamingMetrics": "metrics",
    "ServingMetrics": "metrics",
    "ModelRegistry": "registry",
    "BatchScheduler": "scheduler",
    "ContinuousBatcher": "continuous",
    "MigrationOffer": "continuous",
    "ModelServer": "http",
    "ReplicaFleet": "fleet",
    "InProcessReplica": "fleet",
    "SubprocessReplica": "fleet",
    "parse_roles": "fleet",
    "Router": "router",
    "Autoscaler": "autoscaler",
    "TensorParallelModel": "tp_backend",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
