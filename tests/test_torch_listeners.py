"""The port's fit loop, training listeners and early stopping against the
JAX package, on the CPU.

A JAX network is written to a zip and restored in the port, so both
start from the same weights; the same seeded numpy batches then go
through ``fit`` in both. Scores are held within f32 tolerance (atol
1e-5, rtol 1e-4: the same sgd steps with sums in another order), the
iteration and epoch counts, the listener calls and the tracer's span
names exactly. ``EarlyStoppingTrainer`` must reach the same termination
reason, best epoch and epoch count as the JAX package's, with scores
within 1e-5 relative. The savers: ``InMemoryModelSaver.restore_best``
copies into the live parameters, so a ``fit`` after it moves the
restored weights; ``LocalFileModelSaver`` restores onto the model's own
device.
"""

import collections
import logging
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.observability.tracing import trace as jtrace
from deeplearning4j_tpu.train import early_stopping as jes
from deeplearning4j_tpu.train import listeners as jlis
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.observability import flight_recorder as tfr
from deeplearning4j_tpu_torch.observability.tracing import trace as ttrace
from deeplearning4j_tpu_torch.train import early_stopping as tes
from deeplearning4j_tpu_torch.train import listeners as tlis
from deeplearning4j_tpu_torch.util import model_serializer as tser

ATOL, RTOL = 1e-5, 1e-4
ES_RTOL = 1e-5


def _mln_conf(lr=0.1, tbptt=None):
    b = JaxBuilder.builder().set_seed(2).updater(jupd.sgd(lr))
    if tbptt:
        b = b.backprop_type("tbptt", fwd_length=tbptt)
        return (b.list().layer(jl.LSTM(n_out=4))
                .layer(jl.RnnOutputLayer(n_out=3, activation="softmax"))
                .set_input_type(JIT.recurrent(2, 7)).build())
    return (b.list().layer(jl.DenseLayer(n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.feed_forward(4)).build())


def _graph_conf(lr=0.1):
    g = (JaxBuilder.builder().set_seed(5).updater(jupd.sgd(lr))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.feed_forward(4)))
    g.add_layer("d", jl.DenseLayer(n_out=8, activation="tanh"), "in")
    g.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax"), "d")
    return g.set_outputs("out").build()


def _pair(tmp_path, graph=False, lr=0.1, tbptt=None):
    jn = (JGraph(_graph_conf(lr)) if graph
          else JNet(_mln_conf(lr, tbptt))).init()
    path = str(tmp_path / "net.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def _xy(n=20, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 4)) + y[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[y]


def _iters(x, y, bs=6):
    return (jit.ArrayDataSetIterator(x, y, bs),
            tit.ArrayDataSetIterator(x, y, bs))


class _Calls:
    """Records every hook call (its own class in each package, so each
    executor sees a listener of its own package's base)."""

    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("start", model.epoch_count))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.epoch_count))

    def iteration_done(self, model, iteration, score, batch_size):
        self.calls.append(("iter", iteration, batch_size))
        self.score_type = type(score)


# --------------------------------------------------------- the fit loop

@pytest.mark.parametrize("graph", [False, True])
def test_fit_listeners_see_what_jax_listeners_see(tmp_path, graph):
    jn, tn = _pair(tmp_path, graph)
    x, y = _xy()
    jscores, tscores = (jlis.CollectScoresIterationListener(),
                        tlis.CollectScoresIterationListener())
    jcalls, tcalls = _Calls(), _Calls()
    jn.set_listeners(jscores, jcalls)
    tn.set_listeners(tscores).add_listeners(tcalls)
    jdata, tdata = _iters(x, y)
    jn.fit(jdata, epochs=3)
    tn.fit(tdata, epochs=3)
    assert tn.iteration_count == jn.iteration_count == 12
    assert tn.epoch_count == jn.epoch_count == 3
    assert tcalls.calls == jcalls.calls
    assert [i for i, _ in tscores.scores] == [i for i, _ in jscores.scores]
    np.testing.assert_allclose([s for _, s in tscores.scores],
                               [s for _, s in jscores.scores],
                               atol=ATOL, rtol=RTOL)
    # the loss reaches the listeners as a device tensor, not a float
    assert tcalls.score_type is torch.Tensor


def test_tbptt_chunks_reach_listeners_in_jax_order(tmp_path):
    jn, tn = _pair(tmp_path, tbptt=3)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 7, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))]
    jcalls, tcalls = _Calls(), _Calls()
    jscores, tscores = (jlis.CollectScoresIterationListener(),
                        tlis.CollectScoresIterationListener())
    jn.set_listeners(jcalls, jscores)
    tn.set_listeners(tcalls, tscores)
    jn.fit(JDataSet(x, y), epochs=2)
    tn.fit(TDataSet(x, y), epochs=2)
    assert tcalls.calls == jcalls.calls
    assert len([c for c in tcalls.calls if c[0] == "iter"]) == 6
    np.testing.assert_allclose([s for _, s in tscores.scores],
                               [s for _, s in jscores.scores],
                               atol=ATOL, rtol=RTOL)
    wait, step = tn._step_timing
    assert wait == 0.0 and step > 0      # the last chunk waited on none


# the spans the fit loop opens; a JAX compile watch another test left
# installed in the process adds spans of its own, which are not the
# loop's
FIT_SPANS = ("epoch", "data_wait", "train_step", "train_step_tbptt",
             "listeners")


def _span_names(tracer, fit):
    tracer.clear()
    tracer.enable()
    try:
        fit()
    finally:
        tracer.disable()
    names = collections.Counter(e["name"] for e in tracer.events()
                                if e["name"] in FIT_SPANS)
    tracer.clear()
    return names


@pytest.mark.parametrize("graph", [False, True])
def test_fit_opens_the_jax_spans_and_times_the_data_wait(tmp_path, graph):
    jn, tn = _pair(tmp_path, graph)
    x, y = _xy()
    jdata, tdata = _iters(x, y)
    want = _span_names(jtrace, lambda: jn.fit(jdata, epochs=2))
    got = _span_names(ttrace, lambda: tn.fit(tdata, epochs=2))
    assert got == want
    assert got["data_wait"] == 10 and got["train_step"] == 8
    assert got["epoch"] == 2 and got["listeners"] == 8
    wait, dispatch = tn._step_timing
    assert wait >= 0 and dispatch > 0


def test_fit_exception_reaches_the_flight_recorder(tmp_path):
    _, tn = _pair(tmp_path)

    class Fails(tlis.TrainingListener):
        def iteration_done(self, model, iteration, score, batch_size):
            if iteration == 1:
                raise RuntimeError("listener failed")

    rec = tfr.install(tfr.FlightRecorder(out_dir=str(tmp_path / "fr")))
    try:
        tn.set_listeners(Fails())
        with pytest.raises(RuntimeError, match="listener failed"):
            tn.fit(_iters(*_xy())[1])
    finally:
        tfr.uninstall()
    (bundle,) = os.listdir(tmp_path / "fr")
    assert "exception_fit_loop" in bundle
    events = [e for e in rec.events() if e["kind"] == "exception"]
    assert events[0]["iteration"] == 1 and "listener failed" in \
        events[0]["error"]


# ------------------------------------------------------------ listeners

def test_logging_and_timing_listeners(tmp_path, caplog):
    _, tn = _pair(tmp_path)
    perf = tlis.PerformanceListener(frequency=1, report=True)
    sleepy = tlis.SleepyTrainingListener(timer_iteration_ms=1.0,
                                         timer_epoch_ms=1.0)
    tn.set_listeners(tlis.ScoreIterationListener(2), perf,
                     tlis.TimeIterationListener(8, frequency=2), sleepy)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        tn.fit(_iters(*_xy())[1], epochs=2)
    assert "Score at iteration 0 is" in caplog.text
    assert "Score at iteration 6 is" in caplog.text
    assert "samples/sec" in caplog.text and "remaining ~" in caplog.text
    assert perf.last_samples_per_sec > 0 and perf.last_batches_per_sec > 0


def test_evaluative_listener_equals_jax(tmp_path):
    jn, tn = _pair(tmp_path)
    x, y = _xy()
    xt, yt = _xy(12, seed=3)
    jl_, tl_ = (jlis.EvaluativeListener(jit.ArrayDataSetIterator(xt, yt, 5),
                                        invocation="epoch"),
                tlis.EvaluativeListener(tit.ArrayDataSetIterator(xt, yt, 5),
                                        invocation="epoch"))
    ji, ti = (jlis.EvaluativeListener(JDataSet(xt, yt), frequency=3),
              tlis.EvaluativeListener(TDataSet(xt, yt), frequency=3))
    jn.set_listeners(jl_, ji)
    tn.set_listeners(tl_, ti)
    jdata, tdata = _iters(x, y)
    jn.fit(jdata, epochs=3)
    tn.fit(tdata, epochs=3)
    for j, t in ((jl_, tl_), (ji, ti)):
        assert [e.accuracy() for e in t.evaluations] == \
            [e.accuracy() for e in j.evaluations]
    assert len(tl_.evaluations) == 3 and len(ti.evaluations) == 3


def test_checkpoint_listener_prunes_but_keeps_protected(tmp_path):
    _, tn = _pair(tmp_path)
    d = str(tmp_path / "ckpt")
    ckpt = tlis.CheckpointListener(d, save_every_n_iterations=2,
                                   keep_last=1)
    first = os.path.join(d, "checkpoint_2.zip")
    tlis.protect_checkpoint(first)
    try:
        assert tlis.is_checkpoint_protected(first)
        tn.set_listeners(ckpt)
        tn.fit(_iters(*_xy())[1], epochs=2)       # iterations 0..7
    finally:
        tlis.unprotect_checkpoint(first)
    assert not tlis.is_checkpoint_protected(first)
    assert sorted(os.listdir(d)) == ["checkpoint_2.zip", "checkpoint_6.zip"]
    # the JAX package restores what the port's listener wrote
    back = jser.restore_model(os.path.join(d, "checkpoint_6.zip"))
    assert back.iteration_count == 6
    np.testing.assert_allclose(back.params_flat(), tn.params_flat(),
                               atol=0.05)


# ------------------------------------------------------- early stopping

def _es_config(mod, case, calc_data):
    calc = mod.DataSetLossCalculator(calc_data)
    if case == "patience":
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                mod.MaxEpochsTerminationCondition(8),
                mod.ScoreImprovementEpochTerminationCondition(2)],
            score_calculator=calc, model_saver=mod.InMemoryModelSaver())
    if case == "min_improvement":
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                mod.MaxEpochsTerminationCondition(8),
                mod.ScoreImprovementEpochTerminationCondition(
                    0, min_improvement=0.02)],
            score_calculator=calc, save_last_model=True)
    if case == "best_score":
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                mod.MaxEpochsTerminationCondition(6),
                mod.BestScoreEpochTerminationCondition(0.5)],
            score_calculator=calc, evaluate_every_n_epochs=2)
    if case == "train_loss":
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                mod.MaxEpochsTerminationCondition(3)])
    if case == "max_score":
        return mod.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                mod.MaxEpochsTerminationCondition(5)],
            iteration_termination_conditions=[
                mod.InvalidScoreTerminationCondition(),
                mod.MaxTimeTerminationCondition(600.0),
                mod.MaxScoreTerminationCondition(0.6)],
            score_calculator=calc)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["patience", "min_improvement",
                                  "best_score", "train_loss",
                                  "max_score"])
def test_early_stopping_trainer_equals_jax(tmp_path, case):
    """sgd on a learnable three-class set: the held-out loss falls, then
    stalls (at 0.5) or turns up at epoch 3 (at 1.0, best epoch 2, no
    improvement for 3 epochs); each case stops on its own condition."""
    jn, tn = _pair(tmp_path, lr=1.0 if case == "patience" else 0.5)
    x, y = _xy(30)
    xt, yt = _xy(15, seed=7)
    jtr, ttr = _iters(x, y, 10)
    jres = jes.EarlyStoppingTrainer(
        _es_config(jes, case, jit.ArrayDataSetIterator(xt, yt, 5)),
        jn, jtr).fit()
    tres = tes.EarlyStoppingTrainer(
        _es_config(tes, case, tit.ArrayDataSetIterator(xt, yt, 5)),
        tn, ttr).fit()
    assert (tres.termination_reason, tres.termination_details,
            tres.total_epochs, tres.best_model_epoch) == \
        (jres.termination_reason, jres.termination_details,
         jres.total_epochs, jres.best_model_epoch)
    assert sorted(tres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    np.testing.assert_allclose(
        [tres.score_vs_epoch[k] for k in sorted(tres.score_vs_epoch)],
        [jres.score_vs_epoch[k] for k in sorted(jres.score_vs_epoch)],
        rtol=ES_RTOL, atol=1e-6)
    np.testing.assert_allclose(tres.best_model_score,
                               jres.best_model_score, rtol=ES_RTOL)
    np.testing.assert_allclose(tres.best_model.params_flat(),
                               np.asarray(jres.best_model.params_flat()),
                               atol=ATOL, rtol=RTOL)
    assert tn.listeners == []             # the guard is taken off
    if case == "max_score":
        assert tres.termination_reason == "iteration"
    if case == "patience":
        assert tres.termination_details == \
            "ScoreImprovementEpochTerminationCondition"
        assert (tres.best_model_epoch, tres.total_epochs) == (2, 6)


def test_in_memory_restore_best_then_fit_moves_the_restored_weights(
        tmp_path):
    _, tn = _pair(tmp_path, lr=0.5)
    live = list(tn.parameters())
    saver = tes.InMemoryModelSaver()
    saver.save_best(tn)
    best = tn.params_flat()
    tn.fit(_iters(*_xy())[1])
    assert not np.array_equal(tn.params_flat(), best)
    assert saver.restore_best(tn) is tn
    np.testing.assert_array_equal(tn.params_flat(), best)
    assert all(a is b for a, b in zip(tn.parameters(), live))
    tn.fit(_iters(*_xy())[1])
    moved = tn.params_flat()
    assert not np.array_equal(moved, best)
    # the saved copy is untouched by the fit that followed
    saver.restore_best(tn)
    np.testing.assert_array_equal(tn.params_flat(), best)


def test_local_file_saver_restores_onto_the_models_device(tmp_path,
                                                          monkeypatch):
    _, tn = _pair(tmp_path)
    saver = tes.LocalFileModelSaver(str(tmp_path / "es"))
    saver.save_best(tn)
    saver.save_latest(tn)
    assert sorted(os.listdir(tmp_path / "es")) == ["bestModel.zip",
                                                   "latestModel.zip"]
    seen = []
    real = tser.restore_model

    def spy(path, *, device="cuda"):
        seen.append(device)
        return real(path, device=device)
    monkeypatch.setattr(tser, "restore_model", spy)
    back = saver.restore_best(tn)
    assert seen == [tn.device] and back.device == tn.device
    np.testing.assert_array_equal(back.params_flat(), tn.params_flat())
