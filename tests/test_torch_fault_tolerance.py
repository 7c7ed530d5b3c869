"""The port's ElasticTrainer against the JAX package's, on the CPU.

Both trainers start from the same weights (a JAX network written to a
zip and restored in the port) and see the same seeded numpy batches.
Within the port, a killed-and-resumed run equals the uninterrupted run
bit for bit (the same steps on the same host). Across the packages the
params are held at float32 tolerance: atol 5e-4 (Adam at lr 1e-2 moves
an element by up to lr a step whatever its gradient's size, so one
whose gradient sits at rounding level may step either way: the
tolerance of tests/test_torch_train.py, lr / 20) and rtol 1e-4; losses
and counts exactly where they are counts.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu import chaos as jchaos
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.observability import health as jhealth
from deeplearning4j_tpu.train.fault_tolerance import (
    ElasticTrainer as JTrainer)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos as tchaos
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.observability import health as thealth
from deeplearning4j_tpu_torch.observability.registry import REGISTRY
from deeplearning4j_tpu_torch.train.fault_tolerance import (
    ElasticTrainer as TTrainer)
from deeplearning4j_tpu_torch.util import model_serializer as tser

P_ATOL, RTOL = 5e-4, 1e-4


def _jax_net(seed=2):
    conf = (JaxBuilder.builder().set_seed(seed).updater(jupd.adam(0.01))
            .list().layer(jl.DenseLayer(n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JNet(conf).init()


@pytest.fixture
def zip_path(tmp_path):
    path = str(tmp_path / "init.zip")
    jser.write_model(_jax_net(), path)
    return path


def _port(zip_path):
    return tser.restore_model(zip_path, device="cpu")


def _jax(zip_path):
    return jser.restore_model(zip_path)


def _data(n, seed=0, poison=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = rng.integers(0, 3, 8)
        x = (rng.normal(size=(8, 4)) + y[:, None]).astype(np.float32)
        if i == poison:
            x = x.copy()
            x.flat[0] = np.nan
        out.append((x, np.eye(3, dtype=np.float32)[y]))
    return out


def _tds(data):
    return [TDataSet(x, y) for x, y in data]


def _jds(data):
    return [JDataSet(x, y) for x, y in data]


def _assert_params(tn, jn, atol=P_ATOL):
    got = tser._flatten(tn.params)
    want = {k: np.asarray(v)
            for k, v in jser._flatten_with_paths(jn.params).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=RTOL,
                                   err_msg=k)


def _assert_same(a, b):
    fa, fb = tser._flatten(a.params), tser._flatten(b.params)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    tchaos.uninstall()
    jchaos.uninstall()


@pytest.mark.parametrize("k", [1, 4])
def test_kill_and_resume_equals_uninterrupted(tmp_path, zip_path, k):
    """A crash at step 7 (chaos ``train.step``), then the same command
    again on the checkpoint directory: the resumed run ends where an
    uninterrupted one does, bit for bit, and both equal the JAX
    trainer's uninterrupted run."""
    data = _data(12, seed=1)
    ref = _port(zip_path)
    TTrainer(ref, str(tmp_path / "free"), save_every=4,
             handle_sigterm=False, steps_per_device_call=k).fit(
        _tds(data), until_epoch=2)
    tchaos.install({"faults": [{"site": "train.step", "kind": "crash",
                                "at": [7]}]}, seed=0)
    net = _port(zip_path)
    cdir = str(tmp_path / "crashed")
    with pytest.raises(tchaos.SimulatedCrashError):
        TTrainer(net, cdir, save_every=4, handle_sigterm=False,
                 steps_per_device_call=k).fit(_tds(data), until_epoch=2)
    tchaos.uninstall()
    net2 = _port(zip_path)
    tr2 = TTrainer(net2, cdir, save_every=4, handle_sigterm=False,
                   steps_per_device_call=k)
    assert net2.iteration_count in (4, 8)   # the newest save
    tr2.fit(_tds(data), until_epoch=2)
    assert net2.iteration_count == ref.iteration_count == 24
    _assert_same(net2, ref)
    jn = _jax(zip_path)
    JTrainer(jn, str(tmp_path / "jax"), save_every=4,
             handle_sigterm=False, steps_per_device_call=k).fit(
        _jds(data), until_epoch=2)
    _assert_params(ref, jn)


@pytest.mark.parametrize("k", [1, 4])
def test_rollback_skips_the_poison_batch(tmp_path, zip_path, k):
    """Batch 5 carries a NaN: the trainer rolls back to the last
    checkpoint, replays and skips ordinal (0, 5), as JAX's does; the
    skip set rides in the newest zip."""
    data = _data(10, seed=2, poison=5)
    tn, jn = _port(zip_path), _jax(zip_path)
    tt = TTrainer(tn, str(tmp_path / "t"), save_every=2,
                  handle_sigterm=False, steps_per_device_call=k)
    jt = JTrainer(jn, str(tmp_path / "j"), save_every=2,
                  handle_sigterm=False, steps_per_device_call=k)
    tt.fit(_tds(data))
    jt.fit(_jds(data))
    assert tt.total_rollbacks == jt.total_rollbacks == 1
    assert tt._skip == jt._skip == {(0, 5)}
    assert tn.iteration_count == jn.iteration_count
    assert np.isfinite(float(tn.score_value))
    _assert_params(tn, jn)
    with zipfile.ZipFile(tt.latest_checkpoint()) as z:
        assert json.loads(z.read("data_position.json"))["skip"] == [[0, 5]]


def test_health_rollback_policy_matches_jax(tmp_path, zip_path):
    """A HealthMonitor with the rollback policy trips on the fused
    vector at the poisoned step; the trainer restores and skips it,
    with the LR dropped (which rebuilds the optimizer and drops the
    model's training programs), as the JAX trainer does."""
    data = _data(8, seed=3, poison=3)
    tn, jn = _port(zip_path), _jax(zip_path)
    tn.set_listeners(thealth.HealthMonitor(policy="rollback"))
    jn.set_listeners(jhealth.HealthMonitor(policy="rollback"))
    tt = TTrainer(tn, str(tmp_path / "t"), save_every=2,
                  handle_sigterm=False, lr_drop_on_rollback=0.5)
    jt = JTrainer(jn, str(tmp_path / "j"), save_every=2,
                  handle_sigterm=False, lr_drop_on_rollback=0.5)
    tt.fit(_tds(data))
    jt.fit(_jds(data))
    assert tt.total_rollbacks == jt.total_rollbacks == 1
    assert tt._skip == jt._skip == {(0, 3)}
    assert tn.conf.conf.updater_cfg["lr"] == jn.conf.conf.updater_cfg[
        "lr"] == 0.005
    _assert_params(tn, jn)


def test_corrupt_generation_is_quarantined(tmp_path, zip_path):
    """The newest checkpoint truncated: a new trainer quarantines it
    (``*.corrupt``, counted) and resumes from the one before."""
    data = _data(8, seed=4)
    d = str(tmp_path / "ck")
    TTrainer(_port(zip_path), d, save_every=2, keep=5,
             handle_sigterm=False).fit(_tds(data))
    newest = os.path.join(d, "ckpt_8.zip")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    before = REGISTRY.counter("checkpoint_quarantined_total").value
    net = _port(zip_path)
    tr = TTrainer(net, d, save_every=2, handle_sigterm=False)
    assert os.path.exists(newest + ".corrupt")
    assert tr.latest_checkpoint().endswith("ckpt_6.zip")
    assert net.iteration_count == 6
    assert REGISTRY.counter("checkpoint_quarantined_total").value \
        == before + 1


def test_async_and_sync_saves_hold_equal_arrays(tmp_path, zip_path):
    """The same run with async and with sync checkpoints: every
    generation's arrays and data position are equal; the writes are
    timed under ``checkpoint_write_seconds{phase}``."""
    data = _data(6, seed=5)
    dirs = {}
    for mode in (False, True):
        d = str(tmp_path / f"async{mode}")
        tr = TTrainer(_port(zip_path), d, save_every=2,
                      handle_sigterm=False, async_checkpoint=mode)
        tr.fit(_tds(data))
        tr.close()
        dirs[mode] = d
    # a save queued behind a write in flight is superseded by the next
    # one, so the async run may keep fewer generations; the newest is
    # always written (fit barriers on the writer)
    names = sorted(set(os.listdir(dirs[True]))
                   & set(os.listdir(dirs[False])))
    assert "ckpt_6.zip" in names
    for name in names:
        with zipfile.ZipFile(os.path.join(dirs[False], name)) as a, \
                zipfile.ZipFile(os.path.join(dirs[True], name)) as b:
            assert a.read("data_position.json") == b.read(
                "data_position.json")
            for entry in ("coefficients.npz", "updater_state.npz",
                          "state.npz"):
                assert a.read(entry) == b.read(entry), (name, entry)
    snap = REGISTRY.snapshot()
    for phase in ("blocked", "total"):
        assert any(k.startswith("checkpoint_write_seconds")
                   and f'phase="{phase}"' in k for k in snap), phase


def test_snapshot_zip_is_write_model_byte_for_byte(tmp_path, zip_path):
    net = _port(zip_path)
    net.fit(_tds(_data(1, seed=6))[0])
    tser.write_model(net, str(tmp_path / "a.zip"))
    tser.write_snapshot(tser.snapshot_model(net), str(tmp_path / "b.zip"))
    assert open(tmp_path / "a.zip", "rb").read() == open(
        tmp_path / "b.zip", "rb").read()


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "jax_elastic_ckpt_4.zip")


def _write_jax_fixture(d):
    """The JAX trainer on ``_jax_net()`` and ``_data(8, seed=7)``, saving
    every 2 steps, killed at step 5: its newest generation is
    ``ckpt_4.zip`` (params, Adam state, data position). chip_smoke.py
    resumes the committed copy on the card."""
    jchaos.install({"faults": [{"site": "train.step", "kind": "crash",
                                "at": [5]}]}, seed=0)
    try:
        with pytest.raises(jchaos.SimulatedCrashError):
            JTrainer(_jax_net(), d, save_every=2,
                     handle_sigterm=False).fit(_jds(_data(8, seed=7)),
                                               until_epoch=2)
    finally:
        jchaos.uninstall()
    return os.path.join(d, "ckpt_4.zip")


def test_committed_jax_checkpoint_is_the_jax_trainers(tmp_path):
    """tests/fixtures/jax_elastic_ckpt_4.zip holds what the JAX trainer
    writes for that run today: the same arrays and data position."""
    fresh = _write_jax_fixture(str(tmp_path / "j"))
    with zipfile.ZipFile(FIXTURE) as a, zipfile.ZipFile(fresh) as b:
        assert json.loads(a.read("data_position.json")) == json.loads(
            b.read("data_position.json"))
        for entry in ("coefficients.npz", "updater_state.npz"):
            with np.load(io.BytesIO(a.read(entry))) as x, \
                    np.load(io.BytesIO(b.read(entry))) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_jax_checkpoint_directory_resumes_in_the_port(tmp_path, zip_path):
    """The JAX trainer crashes at step 5; the port's trainer, pointed at
    that directory, resumes from JAX's checkpoint and data position and
    finishes the run; it ends where JAX's uninterrupted run does."""
    data = _data(8, seed=7)
    jchaos.install({"faults": [{"site": "train.step", "kind": "crash",
                                "at": [5]}]}, seed=0)
    d = str(tmp_path / "jax_run")
    with pytest.raises(jchaos.SimulatedCrashError):
        JTrainer(_jax(zip_path), d, save_every=2,
                 handle_sigterm=False).fit(_jds(data), until_epoch=2)
    jchaos.uninstall()
    net = _port(zip_path)
    tr = TTrainer(net, d, save_every=2, handle_sigterm=False)
    assert net.iteration_count == 4 and tr._batch == 4
    tr.fit(_tds(data), until_epoch=2)
    ref = _jax(zip_path)
    JTrainer(ref, str(tmp_path / "jax_free"), save_every=2,
             handle_sigterm=False).fit(_jds(data), until_epoch=2)
    assert net.iteration_count == ref.iteration_count == 16
    _assert_params(net, ref)


def test_sigterm_checkpoints_and_stops(tmp_path, zip_path):
    """The ``sigterm`` chaos kind at step 3 under the trainer's handler:
    the grace checkpoint lands at iteration 3 and fit returns."""
    tchaos.install({"faults": [{"site": "train.step", "kind": "sigterm",
                                "at": [3]}]}, seed=0)
    net = _port(zip_path)
    tr = TTrainer(net, str(tmp_path / "s"), save_every=100,
                  handle_sigterm=True)
    tr.fit(_tds(_data(6, seed=8)))
    assert tr._stop_requested and net.iteration_count == 3
    assert tr.latest_checkpoint().endswith("ckpt_3.zip")


def test_stale_tmp_of_a_dead_writer_is_swept(tmp_path, zip_path):
    d = tmp_path / "sw"
    d.mkdir()
    stale = d / "ckpt_4.zip.tmp999999999"
    stale.write_bytes(b"partial")
    TTrainer(_port(zip_path), str(d), handle_sigterm=False)
    assert not stale.exists()


def test_unported_options_raise(tmp_path, zip_path):
    # mesh_spec= is ported (tests/test_torch_dp_train.py): dp=2 needs two
    # ranks, tensor parallelism waits for A6b
    with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR"):
        TTrainer(_port(zip_path), str(tmp_path / "m"), mesh_spec="dp=2")
    with pytest.raises(NotImplementedError, match="A6b"):
        TTrainer(_port(zip_path), str(tmp_path / "t"), mesh_spec="tp=2")
    with pytest.raises(ValueError, match="steps_per_device_call"):
        TTrainer(_port(zip_path), str(tmp_path / "k"),
                 steps_per_device_call=0)
