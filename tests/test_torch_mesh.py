"""The port's mesh, mesh specs, multihost helpers, ParallelInference and
the data-parallel refusals against the JAX package's, in one process on
the CPU (no process group: the port sees one rank)."""

import logging
import threading

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.parallel import inference as jinf
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import mesh_spec as jspec
from deeplearning4j_tpu.parallel import multihost as jhost
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu_torch.parallel import inference as tinf
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import mesh_spec as tspec
from deeplearning4j_tpu_torch.parallel import multihost as thost
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

pytestmark = pytest.mark.mesh

SPECS = ["dp=4,tp=2", " dp=4 , tp=2 ", {"dp": 4, "tp": 2},
         '{"dp": 4, "tp": 2}', "dp=1", "", "sp=8", "pp=2,dp=2",
         {"dp": 8}, '{"sp": 2, "dp": 4}', "dp=3,,tp=1"]
BAD = ["dp=4,zz=2", "dp=0", "dp=four", "dp:4", 4, '{"dp": ', "dp=-1",
       {"dp": 2.5}, {"dp": 0}, ["dp=2"], '{"qq": 1}']


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_mesh_spec_agrees_with_jax(spec):
    got, want = tspec.parse_mesh_spec(spec), jspec.parse_mesh_spec(spec)
    assert str(got) == str(want) and repr(got) == repr(want)
    assert got.describe() == want.describe()
    assert got.n_devices() == want.n_devices()
    assert tspec.parse_mesh_spec(got) is got


@pytest.mark.parametrize("spec", BAD, ids=repr)
def test_parse_mesh_spec_refuses_what_jax_refuses(spec):
    with pytest.raises(Exception) as want:
        jspec.parse_mesh_spec(spec)
    with pytest.raises(type(want.value)) as got:
        tspec.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dims,n", [((-1, 1, 1, 1), 8), ((2, -1, 1, 1), 8),
                                    ((4, 2, 1, 1), 8), ((3, 1, 1, 1), 8),
                                    ((-1, 1, 1, 2), 6), ((1, 1, 1, 1), 5),
                                    ((-1, 3, 1, 1), 8)])
def test_mesh_spec_resolve_agrees_with_jax(dims, n):
    t, j = tmesh.MeshSpec(*dims), jmesh.MeshSpec(*dims)
    try:
        want = j.resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[")
                           .replace("]", r"\]")):
            t.resolve(n)
        return
    assert t.resolve(n) == want


@pytest.mark.parametrize("n", list(range(1, 18)) + [0, -3])
def test_largest_pow2_agrees_with_jax(n):
    if n < 1:
        for mod in (jmesh, tmesh):
            with pytest.raises(ValueError, match="at least one"):
                mod.largest_pow2(n)
        return
    assert tmesh.largest_pow2(n) == jmesh.largest_pow2(n)


@pytest.mark.parametrize("lost", [{7}, {0}, {1, 2}, {0, 1, 2, 3, 4, 5, 6},
                                  {3, 5, 6}, set()], ids=repr)
def test_shrink_arithmetic_agrees_with_jax(monkeypatch, lost):
    """Which ranks the shrunk mesh keeps, against JAX's device ids (the
    port's process groups stubbed: one process here)."""
    monkeypatch.setattr(tmesh, "_groups", lambda ranks: (None, None, None))
    jm = jmesh.build_mesh(jmesh.MeshSpec(data=8), jax.devices()[:8])
    want = jmesh.shrink_data_mesh(
        jm, {d for d in jm.devices.flat if d.id in lost})
    tm = tmesh.build_mesh(tmesh.MeshSpec(data=8), list(range(8)))
    got = tmesh.shrink_data_mesh(tm, lost)
    assert got.ranks == [d.id for d in want.devices.flat]
    assert got.shape["data"] == want.shape["data"]


def test_shrink_refuses_sharded_axes(monkeypatch):
    """Pipe and seq meshes refuse with JAX's message; a data x model
    mesh keeps the intact dp rows, as JAX's shrink does."""
    monkeypatch.setattr(tmesh, "_groups", lambda ranks: (None, None, None))
    for spec in ({"data": 2, "seq": 2}, {"data": 2, "pipe": 2}):
        m = tmesh.build_mesh(tmesh.MeshSpec(**spec), list(range(4)))
        jm = jmesh.build_mesh(jmesh.MeshSpec(**spec), jax.devices()[:4])
        with pytest.raises(NotImplementedError) as want:
            jmesh.shrink_data_mesh(jm, {jm.devices.flat[3]})
        with pytest.raises(NotImplementedError) as got:
            tmesh.shrink_data_mesh(m, {3})
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="no surviving"):
        tmesh.shrink_data_mesh(tmesh.build_mesh(tmesh.MeshSpec(data=2),
                                                [0, 1]), {0, 1})
    jm = jmesh.build_mesh(jmesh.MeshSpec(data=4, model=2),
                          jax.devices()[:8])
    tm = tmesh.build_mesh(tmesh.MeshSpec(data=4, model=2), list(range(8)))
    for lost in ({7}, {0, 3}, {1, 2, 4}, {0, 2, 4, 6}):
        try:
            want = jmesh.shrink_data_mesh(
                jm, {d for d in jm.devices.flat if d.id in lost})
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                tmesh.shrink_data_mesh(tm, lost)
            continue
        got = tmesh.shrink_data_mesh(tm, lost)
        assert got.ranks == [d.id for d in want.devices.flat]
        assert got.shape == dict(want.shape)


@pytest.mark.parametrize("hosts,rank,batch", [(1, 0, 64), (2, 0, 64),
                                              (2, 1, 64), (4, 3, 16),
                                              (3, 2, 9), (2, 1, 7),
                                              (4, 0, 10)])
def test_local_batch_slice_agrees_with_jax(monkeypatch, hosts, rank, batch):
    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(thost, "process_count", lambda: hosts)
    monkeypatch.setattr(thost, "process_index", lambda: rank)
    try:
        want = jhost.local_batch_slice(batch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            thost.local_batch_slice(batch)
        assert str(got.value) == str(e)
        assert str(batch) in str(e) and str(hosts) in str(e)
        return
    assert thost.local_batch_slice(batch) == want
    seen = thost.per_host_iterator(lambda i, n: (i, n))
    assert seen == jhost.per_host_iterator(lambda i, n: (i, n))


def test_one_process_without_variables(monkeypatch):
    for var in ("DL4J_TPU_COORDINATOR", "MASTER_ADDR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert thost.initialize_distributed(device="cpu") is False
    assert thost.is_coordinator() and tmesh.device_count() == 1
    assert thost.rank_device("cpu") == torch.device("cpu")
    assert tmesh.choose_backend("cpu", 4) == "gloo"


def test_too_many_ranks_names_the_launch_recipe():
    with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR") as e:
        tspec.build_mesh_context("dp=2")
    assert "needs 2 device(s)" in str(e.value)
    with pytest.raises(ValueError, match="xla_force_host_platform"):
        jspec.build_mesh_context(f"dp={2 * jax.device_count()}", None)


@pytest.mark.parametrize("spec", ["tp=2", "pp=2", "sp=2", "dp=1,tp=2"])
def test_tensor_pipeline_and_sequence_meshes_name_a6b(spec):
    """The spec routes as JAX's ``build_mesh_context`` does (these meshes
    once raised naming ROADMAP A6b): tp builds (here it needs the
    ranks, so the error names the launch recipe, where JAX's names the
    virtual devices), pp points to pipeline_spmd and sp to
    ParallelWrapper, each with the type JAX raises."""
    plan = tspec.parse_mesh_spec(spec)
    if plan.tp > 1:
        with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR"):
            tspec.build_mesh_context(spec)
        ctx = jspec.build_mesh_context(spec)
        assert ctx.plan.tp == plan.tp
        return
    with pytest.raises(NotImplementedError) as want:
        jspec.build_mesh_context(spec)
    with pytest.raises(NotImplementedError) as got:
        tspec.build_mesh_context(spec)
    key = "pipeline_spmd.py" if plan.pp > 1 else "ParallelWrapper"
    assert key in str(want.value) and key in str(got.value)


def _tiny(tmp_path, seed=1):
    from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import updaters
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.sgd(0.1)).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    path = str(tmp_path / "m.zip")
    write_model(MultiLayerNetwork(conf).init(), path)
    return restore_model(path, device="cpu")


def test_fit_refusals_and_dp1_in_one_process(tmp_path):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    net = _tiny(tmp_path)
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(6, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)])
    with pytest.raises(NotImplementedError, match="ParallelWrapper"):
        net.fit(ds, mesh_spec="sp=2")
    with pytest.raises(ValueError, match="DL4J_TPU_PROCESS_ID"):
        net.warmup(ds, mesh_spec="dp=2")
    ref = _tiny(tmp_path)
    ref.fit(ds)
    net.fit(ds, mesh_spec="dp=1")
    np.testing.assert_array_equal(net.params_flat(), ref.params_flat())
    assert net._mesh_ctx.describe(net)["reduce"] == \
        "one rank: no collective"
    net.conf.conf.tbptt = {"fwd_length": 2, "bwd_length": 2}
    net._mesh_ctx = None
    with pytest.raises(NotImplementedError, match="tBPTT"):
        net.use_mesh("dp=1")


def test_wrapper_builder_and_describe(tmp_path, caplog):
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    net = _tiny(tmp_path)
    with caplog.at_level(logging.WARNING, "deeplearning4j_tpu_torch"):
        pw = (ParallelWrapper.builder(net).workers(1)
              .averaging_frequency(5).prefetch_buffer(0)
              .dcn_compression(0.1).build())
    assert "ignored" in caplog.text
    assert pw.dcn_compression == {"threshold": 0.1}
    assert not pw.supports_fused_windows()
    d = pw.describe()
    assert d["active"] and d["spec"] == "dp=1" and "int8" in d["reduce"]
    with pytest.raises(ValueError, match="fused"):
        pw.fit_batches([], steps_per_device_call=2)


@pytest.mark.parametrize("rows", [1, 3, 4, 5, 8, 13])
def test_pow2_pad_rows_agrees_with_jax(rows):
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    np.testing.assert_array_equal(tinf.pow2_pad_rows(x),
                                  jinf.pow2_pad_rows(x))


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_parallel_inference_equals_direct_output(tmp_path, mode):
    net = _tiny(tmp_path, seed=4)
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(int(n), 4)).astype(np.float32)
          for n in rng.integers(1, 6, 24)]
    pi = tinf.ParallelInference(net, mode=mode, max_batch_size=8,
                                wait_ms=5.0)
    out = [None] * len(xs)

    def call(i):
        out[i] = pi.output(xs[i])
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(xs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        pi.shutdown()
    for x, got in zip(xs, out):
        want = net.output(x).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_parallel_inference_sheds_when_full(tmp_path):
    net = _tiny(tmp_path)
    gate = threading.Event()
    slow = type("Slow", (), {"output": lambda self, x: (gate.wait(10),
                                                        net.output(x))[1]})()
    pi = tinf.ParallelInference.builder(slow).queue_limit(1) \
        .batch_limit(1).build()
    x = np.zeros((1, 4), np.float32)
    t = threading.Thread(target=lambda: pi.output(x))
    t2 = threading.Thread(target=lambda: pi.output(x))
    t.start()
    t2.start()
    try:
        import time
        deadline = time.time() + 5
        while pi._queue.qsize() < 1 and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(tinf.QueueFullError, match="limit"):
            pi.output(x)
    finally:
        gate.set()
        t.join(10)
        t2.join(10)
        pi.shutdown()


def _usage_flags(main, capsys):
    import re
    with pytest.raises(SystemExit):
        main(["train", "--help"])
    usage = capsys.readouterr().out.split("\n\n")[0]
    return set(re.findall(r"\[?(--[a-z][a-z-]*)", usage))


def test_train_flags_are_jax_flags_and_device(capsys):
    from deeplearning4j_tpu.cli import main as jax_main
    from deeplearning4j_tpu_torch.cli import main as port_main
    assert _usage_flags(port_main, capsys) == \
        _usage_flags(jax_main, capsys) | {"--device"}


@pytest.mark.parametrize("extra", [
    ["--mesh", "dp=2", "--workers", "2"],
    ["--k-step", "0"],
    ["--k-step", "2", "--workers", "2"],
    ["--aot-warmup", "--workers", "2"],
    ["--health", "rollback", "--workers", "2"],
], ids=repr)
def test_train_refusals_match_jax(extra):
    from deeplearning4j_tpu.cli import main as jax_main
    from deeplearning4j_tpu_torch.cli import main as port_main
    argv = ["train", "--model", "nope.zip", "--data", "n.csv",
            "--label-index", "4"] + extra
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        port_main(argv + ["--device", "cpu"])
    # the refusal; the port words the reason of one of them without
    # JAX's compile
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_train_mesh_without_ranks_names_the_recipe(monkeypatch):
    from deeplearning4j_tpu_torch.cli import main as port_main
    monkeypatch.delenv("DL4J_TPU_COORDINATOR", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(SystemExit) as e:
        port_main(["train", "--model", "nope.zip", "--data", "n.csv",
                   "--label-index", "4", "--mesh", "dp=2", "--device",
                   "cpu"])
    assert "2 ranks need 2 processes" in str(e.value)
    assert "DL4J_TPU_NUM_PROCESSES" in str(e.value)


def test_trainer_refuses_windows_on_a_compressed_wrapper(tmp_path):
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.train.fault_tolerance import (
        ElasticTrainer)
    net = _tiny(tmp_path)
    pw = ParallelWrapper(net, tmesh.build_mesh(tmesh.MeshSpec(data=1)),
                         dcn_compression={"threshold": 0.0})
    with pytest.raises(ValueError, match="steps_per_device_call"):
        ElasticTrainer(net, str(tmp_path / "c"), wrapper=pw,
                       steps_per_device_call=2)
    with pytest.raises(ValueError, match="not both"):
        ElasticTrainer(net, str(tmp_path / "d"), wrapper=pw,
                       mesh_spec="dp=1")


def test_the_step_scope_is_per_thread():
    """A data-parallel step's scope is seen on its own thread only: a
    model training on another thread (a parameter-server worker, a
    server's warmup) takes local statistics."""
    from deeplearning4j_tpu_torch.parallel import global_batch
    ctx = tspec.MeshContext.from_mesh(tmesh.build_mesh(tmesh.MeshSpec(data=1)))
    seen = {}
    inside, leave = threading.Event(), threading.Event()

    def step():
        with global_batch.scope(ctx):
            seen["own"] = global_batch.active() is not None
            inside.set()
            leave.wait(10)
        seen["after"] = global_batch.active()

    t = threading.Thread(target=step)
    t.start()
    assert inside.wait(10)
    seen["other"] = global_batch.active()
    x = torch.ones(3)
    assert global_batch.all_reduce_sum(x) is x
    assert global_batch.world() == 1
    leave.set()
    t.join(10)
    assert seen == {"own": True, "other": None, "after": None}
