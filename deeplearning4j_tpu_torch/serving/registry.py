"""Model registry: named, versioned, hot-swappable model hosting
(counterpart of ``deeplearning4j_tpu/serving/registry.py``).
Registering a new version under an existing name swaps the serving
default; in-flight requests finish on the model they resolved."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.serving.errors import ModelNotFoundError

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """Thread-safe name -> {version -> model} map; the serving default
    is the highest registered version."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, Dict[int, object]] = {}
        self._registered_at: Dict[str, Dict[int, float]] = {}

    def register(self, name: str, model,
                 version: Optional[int] = None) -> int:
        """Host ``model`` under ``name`` (version defaults to the
        highest existing + 1). Returns the version."""
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            versions[version] = model
            self._registered_at.setdefault(name, {})[version] = time.time()
            return version

    def get(self, name: str, version: Optional[int] = None):
        """The model (the highest version when ``version`` is None);
        ModelNotFoundError otherwise."""
        return self.resolve(name, version)[0]

    def resolve(self, name: str, version: Optional[int] = None):
        """(model, version actually served); ModelNotFoundError
        otherwise."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError(f"no model named {name!r}")
            if version is None:
                version = max(versions)
            if version not in versions:
                raise ModelNotFoundError(
                    f"model {name!r} has no version {version} "
                    f"(available: {sorted(versions)})")
            return versions[version], version

    def unregister(self, name: str,
                   version: Optional[int] = None) -> None:
        """Swap a version out (every version when ``version`` is None).
        In-flight requests holding the model object complete
        normally."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError(f"no model named {name!r}")
            if version is None:
                del self._models[name]
                self._registered_at.pop(name, None)
                return
            if version not in versions:
                raise ModelNotFoundError(
                    f"model {name!r} has no version {version}")
            del versions[version]
            self._registered_at.get(name, {}).pop(version, None)
            if not versions:
                del self._models[name]
                self._registered_at.pop(name, None)

    def models(self) -> List[dict]:
        """The /v1/models payload."""
        with self._lock:
            return [{
                "name": name,
                "versions": sorted(versions),
                "serving_default": max(versions),
                "registered_at": {
                    str(v): t for v, t in sorted(
                        self._registered_at.get(name, {}).items())},
            } for name, versions in sorted(self._models.items())]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models
