"""The port's evaluators and the executors' evaluate methods against the
JAX package, on the CPU.

Each evaluator (regression, ROC / ROCBinary / ROCMultiClass,
calibration) is fed the same seeded numpy labels and predictions in
both packages; its statistics, curves and ``stats()`` text must be
equal (the same host numpy code, tolerance 0), and the HTML exports the
same text. Then a JAX-written zip restored in the port:
``evaluate_regression``, ``evaluate_roc`` (exact and at 100 steps) and
a two-output graph's ``evaluate_outputs`` (with ``Evaluation`` and with
``ROC``, which takes no mask) agree with the JAX package's within 1e-5
(float32 forwards on both sides, sums in another order). The card test
(``cuda`` marker) holds the evaluators on the card against the CPU.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.evaluation import calibration as jcal
from deeplearning4j_tpu.evaluation import classification as jcls
from deeplearning4j_tpu.evaluation import regression as jreg
from deeplearning4j_tpu.evaluation import roc as jroc
from deeplearning4j_tpu.evaluation import tools as jtools
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import evaluation as tev
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet as TMultiDataSet
from deeplearning4j_tpu_torch.evaluation import calibration as tcal
from deeplearning4j_tpu_torch.evaluation import classification as tcls
from deeplearning4j_tpu_torch.evaluation import regression as treg
from deeplearning4j_tpu_torch.evaluation import roc as troc
from deeplearning4j_tpu_torch.evaluation import tools as ttools
from deeplearning4j_tpu_torch.util import model_serializer as tser

TOL = 1e-5


def _probs(rng, n, c):
    z = rng.normal(size=(n, c))
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


def test_package_exports_every_evaluator():
    from deeplearning4j_tpu import evaluation as jev
    assert sorted(tev.__all__) == sorted(jev.__all__)


# ---------------------------------------------------------- regression

@pytest.mark.parametrize("rank", [2, 3])
def test_regression_stats_equal_jax(rank):
    rng = np.random.default_rng(1)
    shape = (12, 3) if rank == 2 else (4, 5, 3)
    labels = rng.normal(size=shape).astype(np.float32)
    preds = (labels + rng.normal(0, 0.3, shape)).astype(np.float32)
    mask = None if rank == 2 else (rng.random((4, 5)) > 0.3).astype(
        np.float32)
    j, t = jreg.RegressionEvaluation(["a", "b", "c"]), \
        treg.RegressionEvaluation(["a", "b", "c"])
    for _ in range(2):
        j.eval(labels, preds, mask)
        t.eval(labels, preds, mask)
    assert t.stats() == j.stats()
    for col in range(3):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "pearson_correlation", "r_squared"):
            assert getattr(t, m)(col) == getattr(j, m)(col), m
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.average_mean_absolute_error() == \
        j.average_mean_absolute_error()
    assert t.num_columns() == j.num_columns() == 3


# ----------------------------------------------------------------- ROC

@pytest.mark.parametrize("steps", [0, 10])
@pytest.mark.parametrize("two_columns", [False, True])
def test_roc_curves_and_auc_equal_jax(steps, two_columns):
    rng = np.random.default_rng(2)
    y = (rng.random(40) > 0.6).astype(np.float32)
    s = np.clip(y * 0.3 + rng.random(40) * 0.7, 0, 1).astype(np.float32)
    s[::7] = 0.5                                   # ties
    if two_columns:
        y = np.stack([1 - y, y], -1)
        s = np.stack([1 - s, s], -1)
    j, t = jroc.ROC(steps), troc.ROC(steps)
    for part in (slice(0, 25), slice(25, None)):
        j.eval(y[part], s[part])
        t.eval(y[part], s[part])
    assert t.calculate_auc() == j.calculate_auc()
    assert t.calculate_auprc() == j.calculate_auprc()
    for tc, jc in ((t.get_roc_curve(), j.get_roc_curve()),
                   (t.get_precision_recall_curve(),
                    j.get_precision_recall_curve())):
        for name in vars(jc):
            np.testing.assert_array_equal(getattr(tc, name),
                                          getattr(jc, name))
        assert tc.area() == jc.area()


@pytest.mark.parametrize("steps", [0, 20])
def test_roc_binary_and_multiclass_equal_jax(steps):
    rng = np.random.default_rng(3)
    labels = (rng.random((30, 3)) > 0.5).astype(np.float32)
    scores = rng.random((30, 3)).astype(np.float32)
    j, t = jroc.ROCBinary(steps), troc.ROCBinary(steps)
    j.eval(labels, scores)
    t.eval(labels, scores)
    assert [t.calculate_auc(i) for i in range(3)] == \
        [j.calculate_auc(i) for i in range(3)]
    assert t.calculate_average_auc() == j.calculate_average_auc()
    probs = _probs(rng, 30, 4)
    for lab in (_onehot(rng, 30, 4), rng.integers(0, 4, 30)):
        j, t = jroc.ROCMultiClass(steps), troc.ROCMultiClass(steps)
        j.eval(lab, probs)
        t.eval(lab, probs)
        assert [t.calculate_auc(i) for i in range(4)] == \
            [j.calculate_auc(i) for i in range(4)]
        assert t.calculate_average_auc() == j.calculate_average_auc()


# --------------------------------------------------------- calibration

def _calibration_inputs(kind, rng):
    if kind == "series":
        labels = np.stack([_onehot(rng, 6, 3) for _ in range(4)])
        preds = np.stack([_probs(rng, 6, 3) for _ in range(4)])
        return labels, preds, (rng.random((4, 6)) > 0.3).astype(np.float32)
    labels, preds = _onehot(rng, 20, 3), _probs(rng, 20, 3)
    mask = {"none": None,
            "example": (rng.random(20) > 0.2).astype(np.float32),
            "column": (rng.random((20, 1)) > 0.2).astype(np.float32),
            "output": (rng.random((20, 3)) > 0.2).astype(np.float32)}[kind]
    return labels, preds, mask


@pytest.mark.parametrize("kind", ["none", "example", "column", "output",
                                  "series"])
def test_calibration_equal_jax(kind):
    rng = np.random.default_rng(4)
    labels, preds, mask = _calibration_inputs(kind, rng)
    j, t = jcal.EvaluationCalibration(5, 8), tcal.EvaluationCalibration(5, 8)
    j.eval(labels, preds, mask)
    t.eval(labels, preds, mask)
    other_j, other_t = (jcal.EvaluationCalibration(5, 8),
                        tcal.EvaluationCalibration(5, 8))
    l2, p2, _ = _calibration_inputs("none", rng)
    other_j.eval(l2, p2)
    other_t.eval(l2, p2)
    j.merge(other_j)
    t.merge(other_t)
    assert t.stats() == j.stats()
    for cls in range(3):
        for a, b in zip(t.reliability_diagram(cls),
                        j.reliability_diagram(cls)):
            np.testing.assert_array_equal(a, b)
        assert t.expected_calibration_error(cls) == \
            j.expected_calibration_error(cls)
    for cls in (None, 0, 2):
        for fn in ("residual_plot", "probability_histogram"):
            for a, b in zip(getattr(t, fn)(cls), getattr(j, fn)(cls)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.label_counts, j.label_counts)
    np.testing.assert_array_equal(t.prediction_counts, j.prediction_counts)


def test_calibration_refuses_what_jax_refuses():
    t = tcal.EvaluationCalibration()
    assert t.stats() == jcal.EvaluationCalibration().stats()
    with pytest.raises(ValueError, match="mask shape"):
        t.eval(np.eye(3), np.eye(3), mask=np.ones((2, 2)))
    with pytest.raises(ValueError, match="bin counts"):
        t.merge(tcal.EvaluationCalibration(3, 8))


# --------------------------------------------------------- HTML exports

def test_html_exports_write_the_same_text(tmp_path):
    rng = np.random.default_rng(5)
    labels, preds = _onehot(rng, 25, 3), _probs(rng, 25, 3)
    pairs = []
    for mod_cls, mod_roc, mod_cal in ((jcls, jroc, jcal),
                                      (tcls, troc, tcal)):
        ev = mod_cls.Evaluation()
        ev.eval(labels, preds)
        roc = mod_roc.ROC(0)
        roc.eval(labels[:, :1], preds[:, :1])
        cal = mod_cal.EvaluationCalibration()
        cal.eval(labels, preds)
        pairs.append((ev, roc, cal))
    for name in ("export_evaluation_html", "export_roc_html",
                 "export_calibration_html"):
        i = ["export_evaluation_html", "export_roc_html",
             "export_calibration_html"].index(name)
        getattr(jtools, name)(pairs[0][i], str(tmp_path / "j.html"))
        getattr(ttools, name)(pairs[1][i], str(tmp_path / "t.html"))
        assert (tmp_path / "t.html").read_text() == \
            (tmp_path / "j.html").read_text(), name
    with pytest.raises(ValueError, match="no data"):
        ttools.export_calibration_html(tcal.EvaluationCalibration(),
                                       str(tmp_path / "x.html"))


# ---------------------------------------------- the executors' evaluate

def _mln(kind):
    b = (JaxBuilder.builder().set_seed(3).updater(jupd.sgd(0.1)).list()
         .layer(jl.DenseLayer(n_out=8, activation="tanh")))
    if kind == "classifier":
        b = b.layer(jl.OutputLayer(n_out=2, activation="softmax"))
    else:
        b = b.layer(jl.OutputLayer(n_out=3, activation="identity",
                                   loss="mse"))
    return b.set_input_type(JIT.feed_forward(5)).build()


def _graph():
    g = (JaxBuilder.builder().set_seed(4).updater(jupd.sgd(0.1))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.feed_forward(5)))
    g.add_layer("d", jl.DenseLayer(n_out=6, activation="tanh"), "in")
    g.add_layer("cls", jl.OutputLayer(n_out=2, activation="softmax"), "d")
    g.add_layer("reg", jl.OutputLayer(n_out=2, activation="identity",
                                      loss="mse"), "d")
    return g.set_outputs("cls", "reg").build()


def _pair(tmp_path, jnet):
    path = str(tmp_path / "net.zip")
    jser.write_model(jnet.init(), path)
    return jnet, tser.restore_model(path, device="cpu")


def _data(seed=6, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    return x, _onehot(rng, n, 2), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("steps", [0, 100])
def test_mln_evaluate_roc_equals_jax(tmp_path, steps):
    jn, tn = _pair(tmp_path, JNet(_mln("classifier")))
    x, y, _ = _data()
    batches = [(x[:25], y[:25]), (x[25:], y[25:])]
    j = jn.evaluate_roc(jit.ListDataSetIterator(
        [JDataSet(a, b) for a, b in batches]), threshold_steps=steps)
    t = tn.evaluate_roc(tit.ListDataSetIterator(
        [TDataSet(a, b) for a, b in batches]), threshold_steps=steps)
    assert abs(t.calculate_auc() - j.calculate_auc()) <= TOL
    np.testing.assert_allclose(t.get_roc_curve().tpr,
                               j.get_roc_curve().tpr, atol=TOL)
    ev_t, ev_j = tn.evaluate(TDataSet(x, y)), jn.evaluate(JDataSet(x, y))
    assert ev_t.accuracy() == ev_j.accuracy()


def test_mln_evaluate_regression_equals_jax(tmp_path):
    jn, tn = _pair(tmp_path, JNet(_mln("regressor")))
    x, _, y = _data()
    j = jn.evaluate_regression(x, y)
    t = tn.evaluate_regression(x, y)
    for col in range(3):
        np.testing.assert_allclose(
            [t.mean_squared_error(col), t.mean_absolute_error(col),
             t.r_squared(col), t.pearson_correlation(col)],
            [j.mean_squared_error(col), j.mean_absolute_error(col),
             j.r_squared(col), j.pearson_correlation(col)], rtol=TOL)


def test_graph_evaluate_outputs_and_single_outputs_equal_jax(tmp_path):
    jn, tn = _pair(tmp_path, JGraph(_graph()))
    x, y, r = _data()
    jm, tm = (JMultiDataSet([x], [y, y[:, ::-1] * 2.0 - 0.5]),
              TMultiDataSet([x], [y, y[:, ::-1] * 2.0 - 0.5]))
    j, t = jn.evaluate_outputs(jm), tn.evaluate_outputs([tm])
    assert list(t) == list(j) == ["cls", "reg"]
    assert t["cls"].accuracy() == j["cls"].accuracy()
    j = jn.evaluate_outputs(jm, eval_factory=lambda: jroc.ROC(0))
    t = tn.evaluate_outputs(tm, eval_factory=lambda: troc.ROC(0))
    for name in ("cls", "reg"):
        assert abs(t[name].calculate_auc() - j[name].calculate_auc()) <= TOL
    j, t = jn.evaluate_regression(jm, 1), tn.evaluate_regression(tm, 1)
    np.testing.assert_allclose(t.mean_squared_error(0),
                               j.mean_squared_error(0), rtol=TOL)
    j, t = jn.evaluate_roc(jm, 100), tn.evaluate_roc(tm, 100)
    assert abs(t.calculate_auc() - j.calculate_auc()) <= TOL
    assert tn.evaluate(tm).accuracy() == jn.evaluate(jm).accuracy()


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_evaluators_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    path = str(tmp_path / "net.zip")
    jser.write_model(JNet(_mln("classifier")).init(), path)
    cpu = tser.restore_model(path, device="cpu")
    card = tser.restore_model(path, device="cuda")
    x, y, _ = _data(n=256)
    assert card.evaluate(x, y).accuracy() == cpu.evaluate(x, y).accuracy()
    for steps in (0, 100):
        assert abs(card.evaluate_roc(x, y, steps).calculate_auc()
                   - cpu.evaluate_roc(x, y, steps).calculate_auc()) <= TOL
    path = str(tmp_path / "graph.zip")
    jser.write_model(JGraph(_graph()).init(), path)
    cpu = tser.restore_model(path, device="cpu")
    card = tser.restore_model(path, device="cuda")
    mds = TMultiDataSet([x], [y, y * 2.0])
    a, b = card.evaluate_outputs(mds), cpu.evaluate_outputs(mds)
    assert a["cls"].accuracy() == b["cls"].accuracy()
    np.testing.assert_allclose(
        card.evaluate_regression(mds, 1).mean_squared_error(0),
        cpu.evaluate_regression(mds, 1).mean_squared_error(0), rtol=TOL)
