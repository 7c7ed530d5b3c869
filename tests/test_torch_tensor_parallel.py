"""The port's tensor parallelism against the JAX package's, on the CPU.

The rule table, the parameter placement and the squared sums over
shards against JAX's (``parallel/tensor_parallel.py``) in this process;
training (every norm the update takes among it), the health vector and
the stats listener's reports, the checkpoint zip, the elastic dp x tp
shrink and tensor-parallel serving over gloo ranks
(``tests/torch_mp_worker.py``), against the JAX package on one device. Initial weights cross by a zip the JAX package writes.
Tolerances are ``tests/test_parallel.py``'s: rtol 1e-5, atol 1e-6 for
one SGD step of the MLP, rtol 2e-4, atol 2e-5 after Adam steps.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import (ComputationGraph, MultiLayerNetwork,
                                NeuralNetConfiguration)
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (DenseLayer,
                                               EmbeddingSequenceLayer,
                                               GlobalPoolingLayer,
                                               OutputLayer, RnnOutputLayer,
                                               SelfAttentionLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.parallel import tensor_parallel as jtp
from deeplearning4j_tpu.parallel.mesh import MeshSpec, build_mesh
from deeplearning4j_tpu.util.model_serializer import (restore_model,
                                                      write_model)
from deeplearning4j_tpu_torch.parallel import tensor_parallel as ttp
from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model as t_restore)

import torch_dp_worker as worker
import torch_mp_worker as mp

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 8,
                                 reason="needs 8 virtual devices")]

V, T, C = 11, 8, 16


def mlp(seed=9, clip=None):
    b = NeuralNetConfiguration.builder().set_seed(seed)
    if clip is not None:                 # ("norm" | "value", v)
        b = (b.clip_gradient_norm if clip[0] == "norm"
             else b.clip_gradient_value)(clip[1])
    conf = (b.updater(updaters.sgd(0.1)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def mlp_value_clip(seed=9):
    return mlp(seed, clip=("value", 0.05))


def mlp2(seed=9, clip=None, norm=None, constraints=()):
    """Two hidden dense layers: one COLUMN and one ROW split under tp."""
    b = NeuralNetConfiguration.builder().set_seed(seed)
    if clip is not None:
        b = b.clip_gradient_norm(clip)
    if norm is not None:
        b = b.gradient_normalization(*norm)
    b = b.updater(updaters.sgd(0.1)).list()
    for _ in range(2):
        b = b.layer(DenseLayer(n_out=16, activation="tanh",
                               constraints=constraints))
    conf = (b.layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


# every norm the update takes, each active on mlp2's first steps over the
# iris rows (global gradient norm ~3.1; per layer ~2.4, 1.7, 0.9; the
# hidden weights' column norms ~0.5 and ~0.9)
NORM_CASES = {
    "n_clip": {"clip": 1.0},
    "n_rl2l": {"norm": ("renormalize_l2_per_layer",)},
    "n_rl2p": {"norm": ("renormalize_l2_per_param_type",)},
    "n_cl2l": {"norm": ("clip_l2_per_layer", 1.0)},
    "n_cl2p": {"norm": ("clip_l2_per_param_type", 0.5)},
    "n_max": {"constraints": ({"type": "max_norm", "max_norm": 0.5},)},
    "n_minmax": {"constraints": ({"type": "min_max_norm", "min_norm": 0.6,
                                  "max_norm": 0.8, "rate": 0.7},)},
    "n_unit": {"constraints": ({"type": "unit_norm",
                                "apply_to_biases": True},)},
}


def attn_net(seed=7):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(0.01)).list()
            .layer(SelfAttentionLayer(n_out=16, n_heads=4))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(GlobalPoolingLayer(pooling="max"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(8, 8)).build())
    return MultiLayerNetwork(conf).init()


def attn_graph(seed=3, clip=None, updater=None):
    b = NeuralNetConfiguration.builder().set_seed(seed)
    if clip is not None:
        b = b.clip_gradient_norm(clip)
    conf = (b.updater(updater or updaters.adam(0.01)).graph_builder()
            .add_inputs("in")
            .add_layer("attn", SelfAttentionLayer(n_out=16, n_heads=4), "in")
            .add_layer("ff", DenseLayer(n_out=16, activation="relu"), "attn")
            .add_layer("pool", GlobalPoolingLayer(pooling="max"), "ff")
            .add_layer("out", OutputLayer(n_out=3), "pool")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(8, 8)).build())
    return ComputationGraph(conf).init()


def lm(seed=5):
    b = (NeuralNetConfiguration.builder().set_seed(seed)
         .updater(updaters.adam(1e-2)).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=C)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=4, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return MultiLayerNetwork(conf).init()


def _data():
    xs, ys = iris_data()
    rng = np.random.default_rng(0)
    seq_x = rng.normal(0, 1, (64, 8, 8)).astype(np.float32)
    seq_y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    ids = rng.integers(0, V, (8, T)).astype(np.float32)
    ids_y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (8, T))]
    iris = (xs[:64].astype(np.float32), ys[:64].astype(np.float32))
    return {"mlp": iris, "mlpcv": iris,
            "attn": (seq_x, seq_y), "cg": (seq_x, seq_y),
            "lm": (ids, ids_y), "health": iris, "n_cg": (seq_x, seq_y),
            **{name: iris for name in NORM_CASES}}


def cg_norm_clip(seed=3, clip=0.5):
    """The attention graph (heads and a COLUMN dense split) under a
    global-norm clip, trained by SGD."""
    return attn_graph(seed, clip=clip, updater=updaters.sgd(0.1))


MAKERS = {"mlp": mlp, "mlpcv": mlp_value_clip, "attn": attn_net,
          "cg": attn_graph, "lm": lm, "n_cg": cg_norm_clip,
          "health": lambda: mlp2(clip=1.0),
          **{name: (lambda kw=kw: mlp2(**kw))
             for name, kw in NORM_CASES.items()}}
STEPS = {"mlp": 1, "mlpcv": 1, "attn": 3, "cg": 3, "lm": 2, "n_cg": 3,
         "health": 2, **{name: 2 for name in NORM_CASES}}


def _jax_trained(name):
    net = MAKERS[name]()
    x, y = _data()[name]
    for _ in range(STEPS[name]):
        net.fit(DataSet(x, y))
    return net


def _argv(d, scenarios):
    return [sys.executable, mp.__file__, str(d)] + list(scenarios)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _data()
    out = {}
    for world, spec, names, extra in (
            (4, "dp=2,tp=2", ["mlp", "mlpcv", "attn", "cg", "n_cg"]
             + list(NORM_CASES),
             ["elastic:dp=2,tp=2", "tpk:dp=2,tp=2", "tph:dp=2,tp=2"]),
            (2, "tp=2", ["lm"], ["serve:tp=2"])):
        d = tmp_path_factory.mktemp(f"tp{world}")
        for name in names:
            np.savez(d / f"{name}.npz", x=data[name][0], y=data[name][1])
            write_model(MAKERS[name](), str(d / f"{name}.zip"))
        with open(d / "tp.json", "w") as f:
            json.dump([[n, STEPS[n]] for n in names], f)
        if world == 2:
            np.savez(d / "serve.npz", x=data["lm"][0][:5])
            write_model(lm(seed=13), str(d / "serve.zip"))
        else:
            _elastic_inputs(d)
            np.savez(d / "health.npz", x=data["health"][0],
                     y=data["health"][1])
            write_model(MAKERS["health"](), str(d / "health.zip"))
            with open(d / "health.json", "w") as f:
                json.dump(STEPS["health"], f)
        scenarios = [f"tp:{spec}"] + extra
        worker.launch(world, d, scenarios, timeout=150,
                      argv=_argv(d, scenarios))
        out[world] = {s.partition(":")[0]: worker.load(
            d, mp.result_name(s), world) for s in scenarios}
        out[world]["dir"] = d
    return out


# ---- the rule table, in this process

@pytest.mark.parametrize("name", ["mlp", "attn", "lm", "cg"])
def test_rule_table_and_placement_equal_jax(name):
    jn = MAKERS[name]()
    path_net = t_restore_from(jn)
    if name == "cg":
        want = jtp.graph_tp_rules(jn)
        got = ttp.graph_tp_rules(path_net)
    else:
        want = jtp.default_tp_rules(jn.layers)
        got = ttp.default_tp_rules(path_net.layers)
    assert got == want
    # every parameter's split: JAX's PartitionSpec on a 2-way model axis
    mesh = build_mesh(MeshSpec(data=4, model=2), jax.devices()[:8])
    if name == "cg":
        placed = jtp.shard_graph_params(jn.params, jn, mesh)
    else:
        placed = jtp.shard_params(jn.params, jn, mesh)
    plan = ttp.make_plan(path_net, RankGroup(None, None, [0, 1], 0, "gloo"))
    keys = list(placed) if isinstance(placed, dict) else range(len(placed))

    def walk(jt, dims, where):
        if isinstance(jt, dict):
            for k in jt:
                walk(jt[k], dims[k], f"{where}/{k}")
            return
        spec = tuple(jt.sharding.spec)
        want_dim = next((i for i, a in enumerate(spec) if a is not None),
                        None)
        assert dims == want_dim, (where, spec, dims)
    for k in keys:
        walk(placed[k], plan.dims[k], str(k))


def t_restore_from(jn):
    import tempfile
    d = tempfile.mkdtemp()
    path = os.path.join(d, "m.zip")
    write_model(jn, path)
    return t_restore(path, device="cpu")


@pytest.mark.parametrize("name", ["mlp", "lm", "cg"])
def test_shard_params_slices_what_jax_places(name):
    """Each rank's ``shard_params`` (``shard_graph_params``) slice
    equals the shard JAX puts on the device at that model index."""
    jn = MAKERS[name]()
    net = t_restore_from(jn)
    mesh = build_mesh(MeshSpec(data=1, model=2), jax.devices()[:2])
    shard = jtp.shard_graph_params if name == "cg" else jtp.shard_params
    placed = jax.tree_util.tree_leaves(shard(jn.params, jn, mesh))
    for r in range(2):
        class Ctx:                       # this rank's model group
            def model_group(self):
                return RankGroup(None, None, [0, 1], r, "gloo")
        port_shard = ttp.shard_graph_params if name == "cg" \
            else ttp.shard_params
        got = port_shard(net.params, net, Ctx())
        from deeplearning4j_tpu_torch.util.tree import _sorted_leaves
        for jleaf, tleaf in zip(placed, _sorted_leaves(got)):
            want = next(s.data for s in jleaf.addressable_shards
                        if s.device == mesh.devices[0, r])
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(want))


def test_heads_that_do_not_divide_replicate():
    net = t_restore_from(attn_net())
    plan = ttp.make_plan(net, RankGroup(None, None, [0, 1, 2], 0, "gloo"))
    assert plan.mode(0) == ttp.TPRule.REPLICATE        # 4 heads, 3 ranks
    assert ttp._heads_divisible(net.layers[0], 2)
    assert not ttp._heads_divisible(net.layers[0], 3)


# ---- training over ranks

@pytest.mark.parametrize("name,tol", [("mlp", (1e-5, 1e-6)),
                                      ("mlpcv", (1e-5, 1e-6)),
                                      ("attn", (2e-4, 2e-5)),
                                      ("cg", (2e-4, 2e-5))])
def test_dp2_tp2_training_matches_jax_single_device(runs, name, tol):
    want = _jax_trained(name).params_flat()
    ranks = runs[4]["tp"]
    for r in ranks:
        np.testing.assert_allclose(r[name], want, rtol=tol[0], atol=tol[1])
    modes = json.loads(str(ranks[0][name + "_modes"]))["modes"]
    assert set(modes.values()) >= {"column"}, modes


@pytest.mark.parametrize("name", sorted(NORM_CASES) + ["n_cg"])
def test_dp2_tp2_norm_update_matches_jax_single_device(runs, name):
    """Every norm the update takes (the global-norm clip, the four L2
    gradient normalizations, the max / min-max / unit-norm constraints,
    a graph's clip) over dp=2 x tp=2 equals the JAX package's on one
    device, which takes it over the full arrays; and the norm acted
    (the run differs from the same model without it)."""
    want = _jax_trained(name).params_flat()
    ranks = runs[4]["tp"]
    tol = (2e-4, 2e-5) if name == "n_cg" else (1e-5, 1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[name], want, rtol=tol[0], atol=tol[1])
    modes = json.loads(str(ranks[0][name + "_modes"]))["modes"]
    if name == "n_cg":
        assert set(modes.values()) == {"attention_heads", "column"}, modes
        plain = attn_graph(updater=updaters.sgd(0.1))
    else:                # one COLUMN and one ROW split dense layer
        assert modes == {"0": "column", "1": "row"}, modes
        plain = mlp2()
    x, y = _data()[name]
    for _ in range(STEPS[name]):
        plain.fit(DataSet(x, y))
    assert np.abs(plain.params_flat() - want).max() > 1e-3


def _jax_health_and_stats():
    from deeplearning4j_tpu.train.listeners import TrainingListener
    from deeplearning4j_tpu.ui.stats import (InMemoryStatsStorage,
                                             StatsListener)

    class Rows(TrainingListener):
        wants_device_health = True

        def __init__(self):
            self.rows = []

        def iteration_done(self, model, iteration, score, batch_size):
            self.rows.append(np.asarray(model._last_health, np.float32))

    net = MAKERS["health"]()
    rows, storage = Rows(), InMemoryStatsStorage()
    net.set_listeners(rows, StatsListener(storage, frequency=1,
                                          session_id="s",
                                          collect_histograms=False))
    x, y = _data()["health"]
    for _ in range(STEPS["health"]):
        net.fit(DataSet(x, y))
    return net, rows.rows, storage.get_all_updates("s")


def test_dp2_tp2_fused_health_matches_jax_single_device(runs):
    """The fused health vector of each step under dp=2 x tp=2 (norms and
    finiteness over the full arrays) equals the JAX package's on one
    device: finite bits exactly, loss and norms to rtol 1e-5, on every
    rank (each attaches the listener: the vector's all-reduce is over
    the model group), and every rank's parameters agree."""
    net, want, _ = _jax_health_and_stats()
    ranks = runs[4]["tph"]
    for r in ranks:
        np.testing.assert_allclose(r["p"], net.params_flat(), rtol=1e-5,
                                   atol=1e-6)
        got = r["rows"]
        assert got.shape == (STEPS["health"], 5)
        np.testing.assert_array_equal(got[:, 0], np.stack(want)[:, 0])
        np.testing.assert_allclose(got[:, 1:], np.stack(want)[:, 1:],
                                   rtol=1e-5, atol=1e-6)


def test_dp2_tp2_stats_report_matches_jax_single_device(runs):
    """Each StatsListener report under dp=2 x tp=2 reads the full
    parameters: the same names and parameter mean magnitudes as the JAX
    package's reports on one device (rtol 1e-5), and the update mean
    magnitudes of the second report (rtol 1e-4: a difference of
    parameters)."""
    _, _, want = _jax_health_and_stats()
    for r in runs[4]["tph"]:
        got = json.loads(str(r["reports"]))
        assert len(got) == len(want) == STEPS["health"]
        for g, w in zip(got, want):
            assert set(g["param"]) == set(w.param_mean_magnitudes)
            for k, v in w.param_mean_magnitudes.items():
                np.testing.assert_allclose(g["param"][k], v, rtol=1e-5,
                                           err_msg=k)
            assert set(g["update"]) == set(w.update_mean_magnitudes)
            for k, v in w.update_mean_magnitudes.items():
                np.testing.assert_allclose(g["update"][k], v, rtol=1e-4,
                                           atol=1e-8, err_msg=k)


# ---- the squared sums over shards, in this process: two ranks as two
# threads, the model group's all-reduce as an exchange between them

class _Exchange:
    """``collectives.all_reduce_`` over two threads: each rank's tensor
    becomes the sum of both."""

    def __init__(self):
        import threading
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]
        self.calls = [0, 0]

    def __call__(self, t, grp, op="sum", kind="tp"):
        r = grp.index
        self.calls[r] += 1
        self.slots[r] = t.clone()
        self.barrier.wait()
        total = self.slots[0] + self.slots[1]
        self.barrier.wait()
        t.copy_(total)
        return t


def _on_two_ranks(monkeypatch, shards, dims, fn):
    """``fn()`` on each of two simulated ranks, rank r holding
    ``shards[r]`` (a layer's params dict) with split ``dims``, inside
    ``sharded_norms``; returns (the results, the all-reduces each rank
    made)."""
    import threading
    import torch
    from deeplearning4j_tpu_torch.parallel import collectives
    ex = _Exchange()
    monkeypatch.setattr(collectives, "all_reduce_", ex)
    out = [None, None]

    class Model:
        pass

    def rank(r):
        m = Model()
        m.params = [{k: torch.from_numpy(v) for k, v in shards[r].items()}]
        m._tp = ttp.TPPlan(RankGroup(None, None, [0, 1], r, "gloo"),
                           {0: "row"}, {0: dims})
        with ttp.sharded_norms(m):
            out[r] = fn(m.params[0], ttp.norm_dims()[0])

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out, ex.calls


@pytest.mark.parametrize("shape,dim,axes", [
    ((6, 4), 0, (0,)),          # ROW weight, column norms: reduced
    ((6, 4), 1, (0,)),          # COLUMN weight, column norms: local
    ((8,), 0, (0,)),            # a COLUMN layer's bias: reduced
    ((6, 4), 1, None),          # any split leaf, a whole-leaf norm
    ((6, 4), None, (0,)),       # replicated: local, taken once
    ((3, 3, 4, 6), 3, (0, 1, 2)),   # conv by output channels: local
])
def test_sq_sum_of_two_shards_is_the_full_arrays(monkeypatch, shape, dim,
                                                 axes):
    """``tensor_parallel.sq_sum`` on two shards of one array gives each
    rank the full array's squared sum over the axes (a kept split axis:
    this rank's slice of it), all-reducing only across the split."""
    full = np.random.default_rng(len(shape)).normal(
        size=shape).astype(np.float32)
    want = (full.astype(np.float64) ** 2).sum(
        axis=axes, keepdims=axes is not None)
    shards = ([{"w": a} for a in np.split(full, 2, axis=dim)]
              if dim is not None else [{"w": full}, {"w": full}])
    got, calls = _on_two_ranks(
        monkeypatch, shards, {"w": dim},
        lambda p, d: ttp.sq_sum(p["w"], d["w"], axes).numpy())
    crosses = dim is not None and (axes is None or dim in axes)
    assert calls == ([1, 1] if crosses else [0, 0])
    for r in (0, 1):
        part = want if crosses or dim is None or axes is None \
            else np.split(want, 2, axis=dim)[r]
        np.testing.assert_allclose(got[r], part, rtol=1e-5)


def test_tree_sq_sum_counts_replicated_leaves_once(monkeypatch):
    """A layer's squared sum over split and replicated leaves: the split
    partials in one all-reduce, the replicated bias added once."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    shards = [{"W": a, "b": b} for a in np.split(w, 2, axis=0)]
    got, calls = _on_two_ranks(
        monkeypatch, shards, {"W": 0, "b": None},
        lambda p, d: float(ttp.tree_sq_sum(p, d)))
    assert calls == [1, 1]
    want = float((w.astype(np.float64) ** 2).sum()
                 + (b.astype(np.float64) ** 2).sum())
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


def test_tp2_lm_matches_jax_and_its_zip_loads_into_jax(runs):
    jn = _jax_trained("lm")
    ranks = runs[2]["tp"]
    for r in ranks:
        np.testing.assert_allclose(r["lm"], jn.params_flat(), rtol=2e-4,
                                   atol=2e-5)
    modes = json.loads(str(ranks[0]["lm_modes"]))["modes"]
    assert modes == {"1": "attention_heads", "2": "attention_heads"}
    # the tp=2 zip: the full parameters, in JAX's layout
    zpath = str(runs[2]["dir"] / "lm_tp.zip")
    loaded = restore_model(zpath)
    np.testing.assert_allclose(loaded.params_flat(), jn.params_flat(),
                               rtol=2e-4, atol=2e-5)
    jpath = str(runs[2]["dir"] / "lm_jax.zip")
    write_model(jn, jpath)
    import zipfile
    with zipfile.ZipFile(zpath) as zt, zipfile.ZipFile(jpath) as zj:
        for entry in ("coefficients.npz", "updater_state.npz"):
            with zt.open(entry) as ft, zj.open(entry) as fj:
                at, aj = np.load(ft), np.load(fj)
                assert sorted(at.files) == sorted(aj.files)
                for k in aj.files:
                    assert at[k].shape == aj[k].shape, k
                    np.testing.assert_allclose(at[k], aj[k], rtol=2e-4,
                                               atol=2e-5, err_msg=k)


def test_dp2_tp2_kstep_windows_and_warmup(runs):
    """k=2 windows equal k=1 steps under dp=2 x tp=2; ``warmup`` builds
    the tensor-parallel programs and leaves the parameters as they
    were."""
    for r in runs[4]["tpk"]:
        assert int(r["it1"]) == int(r["it2"]) == 4
        np.testing.assert_allclose(r["k2"], r["k1"], rtol=1e-6, atol=1e-7)
        assert bool(r["warm_unchanged"])
        assert r["warm_keys"].tolist() == ["kstep_2", "train_step"]


# ---- the elastic shrink of a dp x tp mesh

def _elastic_inputs(d):
    x, y = _data()["mlp"]
    np.savez(d / "elastic.npz", x=x[:48], y=y[:48])
    write_model(mlp(seed=9), str(d / "elastic.zip"))


def test_dp_tp_shrink_resume(runs):
    """dp=2 x tp=2 under ElasticTrainer: a rank loss at batch 3 drops its
    dp row (tp kept, the shards re-placed), the run completes on the
    survivors; a fresh trainer resumes the checkpoint onto the full
    mesh and finishes (the JAX ``test_dp_tp_shrink_resume_e2e``)."""
    ranks = runs[4]["elastic"]
    for r in ranks:
        assert np.isfinite(r["p_after_restart"]).all()
        assert int(r["resumed_it"]) > 0
    survivors = [r for r in ranks if bool(r["active"])]
    assert len(survivors) == 2
    for r in survivors:
        assert r["shape"].tolist() == [1, 2]      # dp=1, tp=2
        assert int(r["it"]) == 6
    assert all(r["shape_restart"].tolist() == [2, 2] for r in ranks)
    np.testing.assert_array_equal(survivors[0]["p"], survivors[1]["p"])


# ---- serving

def test_tp2_serving_equals_the_unsharded_model(runs):
    leader, follower = runs[2]["serve"]
    np.testing.assert_allclose(leader["got"], leader["want"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(leader["one"], leader["want"][:3],
                               rtol=1e-5, atol=1e-6)
    # a bad batch: refused on the leader, or failing on every rank; the
    # follower stays in step and the next predict is answered
    assert "takes (rows, T) ids" in str(leader["checked"])
    assert str(leader["failed"]), "the unchecked bad forward ran"
    np.testing.assert_allclose(leader["after"], leader["want"], rtol=1e-5,
                               atol=1e-6)
    assert int(follower["forwards"]) >= 3
    assert json.loads(str(leader["health"]))["axes"]["tp"] == 2
    assert "generate is not supported" in str(leader["refused"])


def test_tp2_warmup_bucket_shutdown_and_evict(runs):
    """``TensorParallelModel.warmup_bucket`` runs a new bucket's forward
    over the ranks (its seconds; 0.0 once warm, and for a bucket the
    predicts ran), ``shutdown`` returns True, and
    ``ModelServer.evict_model`` drops the tp wrap."""
    leader, follower = runs[2]["serve"]
    first, again, served = leader["warm"].tolist()
    assert first > 0.0 and again == 0.0 and served == 0.0
    assert bool(leader["shut"]) and bool(leader["evicted"])
    assert "registered after the mesh server started" in str(leader["gone"])
    assert int(follower["forwards"]) >= 4


def test_serve_mesh_cli_two_ranks(tmp_path):
    """``serve --mesh tp=2`` as two rank processes: rank 0 refuses a
    malformed /v1/predict (400) and answers the next with the unsharded
    model's output, /healthz shows the mesh, ctrl-c drains rank 0 and
    stops the follower."""
    net = lm(seed=21)
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    ids = np.random.default_rng(4).integers(0, V, (3, T)).astype(np.float32)
    want = np.asarray(net.output(ids))
    coord, http = worker.free_port(), worker.free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                   DL4J_TPU_COORDINATOR=f"127.0.0.1:{coord}",
                   DL4J_TPU_NUM_PROCESSES="2",
                   DL4J_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
             "--model", f"m={path}", "--mesh", "tp=2", "--device", "cpu",
             "--port", str(http)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        base = f"http://127.0.0.1:{http}"
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert time.monotonic() < deadline, "rank 0 never served"
                assert procs[0].poll() is None, procs[0].stdout.read()
                time.sleep(0.3)
        assert health["mesh"]["axes"]["tp"] == 2
        bad = urllib.request.Request(      # (3, T, 2): not (B, T) ids
            base + "/v1/predict",
            data=json.dumps({"model": "m", "inputs":
                             ids[..., None].repeat(2, -1).tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as refused:
            urllib.request.urlopen(bad, timeout=60)
        assert refused.value.code == 400
        req = urllib.request.Request(
            base + "/v1/predict",
            data=json.dumps({"model": "m", "inputs": ids.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["outputs"], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        procs[0].send_signal(signal.SIGINT)
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert procs[0].returncode == 0, logs[0]
    assert procs[1].returncode == 0, logs[1]
    assert "draining" in logs[0] and "serving mesh: tp=2" in logs[0]
    assert "following the mesh's rank 0" in logs[1]


@pytest.mark.parametrize("argv,jax_says", [
    (["--mesh", "sp=2"], "sp belongs to training"),
    (["--mesh", "dp=2,pp=2"], None),
    (["--mesh", "tp=2"], "xla_force_host_platform"),
])
def test_serve_mesh_refusals(tmp_path, argv, jax_says):
    """The port's ``serve --mesh`` refuses what JAX's ModelServer
    refuses, before it serves."""
    from deeplearning4j_tpu.serving.http import ModelServer as JServer
    from deeplearning4j_tpu.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.cli import main
    path = str(tmp_path / "m.zip")
    write_model(mlp(), path)
    spec = argv[1]
    reg = ModelRegistry()
    reg.register("m", mlp())
    if jax_says is not None and spec != "tp=2":
        with pytest.raises(Exception, match=jax_says):
            JServer(reg, mesh=spec)
    else:
        with pytest.raises(Exception):
            JServer(reg, mesh=spec if spec != "tp=2" else "tp=16")
    with pytest.raises(SystemExit) as e:
        main(["serve", "--model", f"m={path}", "--device", "cpu"] + argv)
    msg = str(e.value)
    if spec == "tp=2":
        assert "DL4J_TPU_COORDINATOR" in msg
    else:
        assert "serving meshes take dp/tp axes only" in msg


@pytest.mark.parametrize("spec,key", [("dp=1,pp=2", "pipeline_spmd.py"),
                                      ("sp=2", "ParallelWrapper"),
                                      ("tp=2", "DL4J_TPU_COORDINATOR")])
def test_train_mesh_routes_as_jax(tmp_path, spec, key):
    """``train --mesh``: tp needs its ranks (the launch recipe, one
    process here), pp and sp exit naming where they run, as JAX's
    ``use_mesh`` raises."""
    from deeplearning4j_tpu.parallel.mesh_spec import build_mesh_context
    from deeplearning4j_tpu_torch.cli import main
    path = str(tmp_path / "m.zip")
    write_model(mlp(), path)
    csv = tmp_path / "d.csv"
    csv.write_text("0.1,0.2,0.3,0.4,1\n" * 8)
    if key != "DL4J_TPU_COORDINATOR":
        with pytest.raises(NotImplementedError, match=key):
            build_mesh_context(spec)
    with pytest.raises(SystemExit) as e:
        main(["train", "--model", path, "--data", str(csv),
              "--label-index", "4", "--classes", "3", "--mesh", spec,
              "--device", "cpu"])
    assert key in str(e.value)
