"""Estimator-style ML pipeline wrappers (counterpart of
``deeplearning4j_tpu/ml/estimators.py``).

Mirrors dl4j-spark-ml's Spark ML integration (dl4j-spark-ml/src/main/
spark-2/scala/.../SparkDl4jNetwork.scala: an Estimator whose ``fit``
returns a Model with ``transform``/``predict``). Spark's DataFrame
becomes plain arrays / DataSet; the mesh data-parallel trainer replaces
Spark executors. The fit→model→transform contract (and sklearn-style
get_params/set_params for grid searching) is what survives.

The networks run on the estimator's ``device`` (default ``"cuda"``);
``transform`` returns host numpy. With ``mesh=`` (the port's
``parallel.mesh.Mesh``: one process a rank, as in
``parallel/wrapper.py``) every rank calls ``fit`` with the same full
arrays, as the JAX estimator is given them: each global batch is cut to
the rank's rows (``ParallelWrapper.local_shard``), and the port's
``ParallelWrapper`` all-reduces the gradients, so every rank ends with
the same model.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["NetworkEstimator", "NetworkModel"]


class NetworkModel:
    """Fitted model (SparkDl4jModel equivalent): transform/predict over
    arrays."""

    def __init__(self, network, normalizer=None):
        self.network = network
        self.normalizer = normalizer

    def _prep(self, x):
        x = np.asarray(x)
        if self.normalizer is not None:
            x = np.asarray(self.normalizer.transform_features(x))
        return x

    def transform(self, x) -> np.ndarray:
        """Class-probability outputs (Spark ML transform adds a
        probability column; here: the array, on the host)."""
        out = self.network.output(self._prep(x))
        if isinstance(out, tuple):
            out = out[0]
        return out.float().cpu().numpy()

    def predict(self, x) -> np.ndarray:
        """argmax class ids."""
        return self.transform(x).argmax(axis=-1)

    def score(self, x, y) -> float:
        """Accuracy against one-hot or index labels."""
        y = np.asarray(y)
        if y.ndim > 1:
            y = y.argmax(axis=-1)
        return float((self.predict(x) == y).mean())

    def save(self, path: str):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model)
        write_model(self.network, path,
                    normalizer=(self.normalizer.to_dict()
                                if self.normalizer is not None else None))

    @staticmethod
    def load(path: str, device="cuda") -> "NetworkModel":
        """A zip written by either package's ``save`` (or
        ``write_model`` with a normalizer), on ``device``."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model, restore_normalizer)
        return NetworkModel(restore_model(path, device=device),
                            restore_normalizer(path))


class NetworkEstimator:
    """Unfitted estimator (SparkDl4jNetwork equivalent).

    Parameters
    ----------
    conf_factory: zero-arg callable returning a fresh
        MultiLayerConfiguration / ComputationGraphConfiguration (a new
        config per fit, like the Scala wrapper re-broadcasting a fresh
        net per run).
    epochs / batch_size: training loop knobs.
    normalize: fit a NormalizerStandardize on the training features.
    mesh: optional port ``Mesh`` (``parallel.mesh.build_mesh``) — train
        data-parallel via ParallelWrapper (the Spark-executors analog);
        every rank calls ``fit`` with the same arrays.
    device: where the network trains (default cuda).
    """

    def __init__(self, conf_factory, *, epochs: int = 10,
                 batch_size: Optional[int] = None,
                 normalize: bool = False, mesh=None, seed: int = 0,
                 device="cuda"):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.normalize = normalize
        self.mesh = mesh
        self.seed = seed
        self.device = device

    # sklearn-style param plumbing (grid-search friendly)
    def get_params(self) -> dict:
        return {"epochs": self.epochs, "batch_size": self.batch_size,
                "normalize": self.normalize, "seed": self.seed}

    def set_params(self, **kw) -> "NetworkEstimator":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown param '{k}'")
            setattr(self, k, v)
        return self

    def fit(self, x, y) -> NetworkModel:
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph)
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration)

        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        normalizer = None
        if self.normalize:
            from deeplearning4j_tpu_torch.data.normalizers import (
                NormalizerStandardize)
            normalizer = NormalizerStandardize().fit(DataSet(x, None))
            x = np.asarray(normalizer.transform_features(x))

        conf = self.conf_factory()
        if isinstance(conf, ComputationGraphConfiguration):
            net = ComputationGraph(conf, device=self.device).init(self.seed)
        else:
            net = MultiLayerNetwork(conf, device=self.device).init(self.seed)

        if self.mesh is not None:
            from deeplearning4j_tpu_torch.data.iterators import (
                ListDataSetIterator)
            from deeplearning4j_tpu_torch.parallel.wrapper import (
                ParallelWrapper)
            bs = self.batch_size or x.shape[0]
            pw = ParallelWrapper(net, self.mesh, prefetch_buffer=0)
            local = [DataSet(pw.local_shard(b.features),
                             pw.local_shard(b.labels))
                     for b in DataSet(x, y).batch_by(bs)]
            pw.fit(ListDataSetIterator(local), epochs=self.epochs)
        elif isinstance(net, ComputationGraph):
            ds = DataSet(x, y)
            data = (ds.batch_by(self.batch_size)
                    if self.batch_size else [ds])
            net.fit(data, epochs=self.epochs)
        else:
            net.fit(x, y, epochs=self.epochs,
                    batch_size=self.batch_size)
        return NetworkModel(net, normalizer)
