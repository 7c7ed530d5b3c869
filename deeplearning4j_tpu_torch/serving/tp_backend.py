"""Tensor-parallel predict backend: one model sharded over the ranks of
a mesh (counterpart of ``deeplearning4j_tpu/serving/tp_backend.py``).

A :class:`TensorParallelModel` wraps a hosted MultiLayerNetwork with its
parameters sharded over the mesh's ``model`` axis by the Megatron rule
table (``parallel/tensor_parallel.py``), and a ``dp`` axis splitting the
request rows, behind the same ``output()`` surface the
``BatchScheduler`` drives, so the serving stack runs tensor-parallel
without knowing it.

The JAX proxy is one process driving every device. Here every rank is a
process: rank 0 of the mesh (the leader) hosts the ``ModelServer``, and
every other rank runs :func:`follow`. For each forward the leader
broadcasts a header (which hosted model, the padded batch's shape) and
the rows over the mesh's gloo host group; every rank then runs its
shard of the forward on its own rows (its data index's slice), joining
the model group's all-reduces inside the layers, and the data group
gathers the rows back. Rows are padded to pow2 buckets
(``parallel/inference.pow2_pad_rows``), then to a multiple of dp, and
sliced back. :func:`stop_followers` sends the followers home. Every
rank builds the same proxies in the same order (the construction is
collective: the mesh's groups, the parameters' broadcast and shards).

Generate and streaming stay unsharded: the proxy does not advertise
them, so the server routes generate around it (as in the JAX package,
which refuses generate on a mesh-sharded server).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["TensorParallelModel", "host_models", "follow",
           "stop_followers"]

_OP_STOP, _OP_FORWARD = 0, 1
_HEAD = 10                      # op, model index, ndim, up to 7 dims

# every proxy of this process in construction order: a header names one
# by its index, the same on every rank
_HOSTED: List["TensorParallelModel"] = []
# one forward on the mesh at a time (the ranks must see the same order)
_CHANNEL = threading.Lock()


class TensorParallelModel:
    """Serving proxy: ``model`` (a MultiLayerNetwork) with its params
    sharded over ``mesh_spec`` (``"tp=2"``, ``"dp=2,tp=2"``). Every rank
    of the mesh constructs it, with the same model; only the leader
    (mesh rank 0) calls :meth:`output`, the others :func:`follow`."""

    def __init__(self, model, mesh_spec, devices=None):
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        from deeplearning4j_tpu_torch.parallel.mesh_spec import (
            build_mesh_context)
        from deeplearning4j_tpu_torch.serving.errors import ServingError
        if not isinstance(model, MultiLayerNetwork):
            raise ServingError(
                "tensor-parallel serving supports sequential executors "
                f"(MultiLayerNetwork); got {type(model).__name__}")
        self.model = model
        self.ctx = build_mesh_context(mesh_spec, model, devices)
        if self.ctx.plan.sp > 1:
            raise ServingError("serving meshes take dp/tp axes only; sp "
                               "belongs to training")
        if model.params is None:
            model.init()
        self.ctx.place_model(model)
        self.leader = self.ctx.member and self.ctx.rank == 0
        self.forwards = 0
        self._warm = set()      # padded batch shapes run on the mesh
        self.index = len(_HOSTED)
        _HOSTED.append(self)

    # ---- the scheduler-facing surface ----
    @property
    def conf(self):
        return self.model.conf

    def mesh_desc(self) -> dict:
        return self.ctx.describe(self.model)

    def _padded(self, x: np.ndarray) -> np.ndarray:
        from deeplearning4j_tpu_torch.parallel.inference import (
            pow2_pad_rows)
        xp = pow2_pad_rows(x)
        dp = self.ctx.plan.dp
        if xp.shape[0] % dp:
            pad = dp - xp.shape[0] % dp
            xp = np.concatenate([xp, np.zeros((pad,) + xp.shape[1:],
                                              xp.dtype)])
        return xp

    def output(self, x, training: bool = False):
        """The sharded forward, the contract of ``model.output``: rows
        padded to a pow2 bucket (then a multiple of dp) and sliced back.
        The leader only; returns a tensor on the model's device."""
        if not self.leader:
            raise RuntimeError("only the mesh's rank 0 serves; the other "
                               "ranks run tp_backend.follow()")
        x = np.asarray(x, np.float32)
        _check_rows(self.model, x)
        return self._run(self._padded(x))[:x.shape[0]]

    def _run(self, xp: np.ndarray) -> torch.Tensor:
        """The header and the padded rows out to every rank, then this
        rank's forward (the leader's side of :func:`follow`). A failed
        collective (a rank of the mesh is gone) is the replica's fault,
        not the request's: it raises ``ServerClosedError`` (503), which a
        fleet's router fails over."""
        from deeplearning4j_tpu_torch.serving.errors import (
            ServerClosedError)
        with _CHANNEL:
            try:
                head = _header(_OP_FORWARD, self.index, xp.shape)
                self._broadcast(head)
                data = torch.from_numpy(np.ascontiguousarray(xp))
                self._broadcast(data)
                y = self._forward_rows(data)
                self._warm.add(tuple(xp.shape))
                return y
            except dist.DistError as e:
                raise ServerClosedError(
                    f"the serving mesh lost a rank: {e}") from e

    def warmup_bucket(self, batch_rows: int,
                      per_item_shape: Tuple[int, ...]) -> float:
        """Run one forward of ``batch_rows`` zero rows of
        ``per_item_shape`` over the mesh's ranks (padded as a request
        is) without serving a request: the shape's first-call costs
        (cuBLAS and cuDNN workspaces and heuristics, the collectives'
        buffers) paid before traffic. Returns its seconds, 0.0 when that
        padded shape already ran. The leader only."""
        import time
        if not self.leader:
            raise RuntimeError("only the mesh's rank 0 warms buckets; the "
                               "other ranks run tp_backend.follow()")
        xp = self._padded(np.zeros((int(batch_rows),)
                                   + tuple(per_item_shape), np.float32))
        if tuple(xp.shape) in self._warm:
            return 0.0
        t0 = time.perf_counter()
        y = self._run(xp)
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        return time.perf_counter() - t0

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """The backend lifecycle's call: the proxy owns no worker thread
        or queue, only the sharded parameters, which go with the object
        (``ModelServer.evict_model`` drops it). Returns True, as the JAX
        package's."""
        return True

    def _broadcast(self, t: torch.Tensor) -> None:
        from deeplearning4j_tpu_torch.parallel.collectives import (
            lost_rank_as_dist_error)
        mesh = self.ctx.mesh
        if mesh.group is not None and mesh.size > 1:
            with lost_rank_as_dist_error():
                dist.broadcast(t, src=mesh.ranks[0], group=mesh.host_group)

    def _forward_rows(self, data: torch.Tensor) -> torch.Tensor:
        """This rank's rows (its data index's slice) through its shards;
        the data group's rows gathered back, in order."""
        from deeplearning4j_tpu_torch.parallel import collectives
        ctx = self.ctx
        rows = ctx.local_shard(data, temporal=False)
        x = rows.to(self.model.device)
        with torch.inference_mode():
            y, _, _ = self.model._forward(x, training=False)
        self.forwards += 1
        grp = ctx.data_group()
        if grp.size == 1:
            return y
        # rows are the leading dim: gather them as the last dim
        moved = y.movedim(0, -1).contiguous()
        return collectives.all_gather_last(moved, grp).movedim(-1, 0)

    # streaming generate stays on the unsharded model: the proxy must
    # not advertise the sessions and then serve them unsharded
    def __getattr__(self, name):
        if name in ("slot_streaming_session",
                    "paged_slot_streaming_session", "streaming_session"):
            raise AttributeError(name)
        return getattr(self.model, name)


def host_models(registry, mesh_spec) -> dict:
    """A :class:`TensorParallelModel` for every model of ``registry``
    (its served version), in registry order: what ``ModelServer(mesh=)``
    builds on the leader and what every follower rank builds before
    :func:`follow`. Collective over the mesh. Returns {(name, version):
    proxy}."""
    out = {}
    for entry in registry.models():
        model, version = registry.resolve(entry["name"])
        out[(entry["name"], version)] = TensorParallelModel(model,
                                                            mesh_spec)
    return out


def _check_rows(model, x: np.ndarray) -> None:
    """Refuse, on the leader and before any rank sees it, a batch the
    model's first layer cannot take: no rows, more dims than the header
    holds, ids of the wrong rank for an embedding, or a feature width
    other than a dense, recurrent or attention layer's ``n_in``. A batch
    that passes and still fails in the forward fails on every rank
    alike (the rows are the same), and :func:`follow` goes on."""
    from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
        SelfAttentionLayer, TransformerEncoderLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.core import (
        DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
        BaseRecurrentLayer)
    if x.ndim < 1 or x.shape[0] == 0 or x.ndim > _HEAD - 3:
        raise ValueError(f"predict takes 1 to {_HEAD - 3} dims with at "
                         f"least one row; got shape {list(x.shape)}")
    if 0 in (getattr(model.conf, "preprocessors", None) or {}):
        return                  # a reshape first: the layer sees another
    layer = model.layers[0]
    if isinstance(layer, EmbeddingSequenceLayer):
        ok, want = (x.ndim == 2 or (x.ndim == 3 and x.shape[2] == 1),
                    "(rows, T) ids")
    elif isinstance(layer, EmbeddingLayer):
        ok, want = (x.ndim == 1 or (x.ndim == 2 and x.shape[1] == 1),
                    "(rows,) ids")
    elif isinstance(layer, (DenseLayer, OutputLayer, BaseRecurrentLayer,
                            SelfAttentionLayer, TransformerEncoderLayer)):
        n_in = getattr(layer, "n_in", None)
        if not n_in:
            return
        ok, want = (x.ndim in (2, 3) and x.shape[-1] == n_in,
                    f"rows of {n_in} features")
    else:
        return
    if not ok:
        raise ValueError(f"the model's first layer ({type(layer).__name__})"
                         f" takes {want}; got shape {list(x.shape)}")


def _header(op: int, index: int = 0, shape=()) -> torch.Tensor:
    head = torch.zeros(_HEAD, dtype=torch.int64)
    head[0], head[1], head[2] = op, index, len(shape)
    head[3:3 + len(shape)] = torch.tensor(list(shape), dtype=torch.int64)
    return head


def follow(models: Optional[List[TensorParallelModel]] = None) -> int:
    """A follower rank's loop: take each header the leader broadcasts,
    run the named proxy's shard of the forward on its rows, until the
    leader sends STOP. A forward that raises is logged and the loop goes
    on (the leader's raised alike). Returns the number of forwards that
    ran to their end."""
    models = list(models) if models is not None else list(_HOSTED)
    if not models:
        raise ValueError("no tensor-parallel model is hosted here")
    first = models[0]
    if first.leader:
        raise RuntimeError("the leader serves; follow() is for the "
                           "other ranks")
    done = 0
    while True:
        head = _header(_OP_STOP)
        first._broadcast(head)
        op, index, ndim = (int(v) for v in head[:3])
        if op == _OP_STOP:
            return done
        tp = _HOSTED[index]
        data = torch.empty(tuple(int(v) for v in head[3:3 + ndim]),
                           dtype=torch.float32)
        tp._broadcast(data)
        try:
            tp._forward_rows(data)
        except Exception:
            # the leader's forward failed alike and became its reply:
            # stay in step for the next header
            logger.exception("tensor-parallel forward %d failed on this "
                             "rank", done)
            continue
        done += 1


def stop_followers() -> None:
    """The leader sends STOP: every follower's :func:`follow` returns."""
    if not _HOSTED:
        return
    first = _HOSTED[0]
    if first.leader:
        with _CHANNEL:
            first._broadcast(_header(_OP_STOP))
