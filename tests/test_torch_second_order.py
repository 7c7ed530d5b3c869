"""The port's full-batch solvers (``train/second_order.py``: L-BFGS,
conjugate gradient, line gradient descent over the flat parameter
vector) against the JAX package's, on the iris fits of
tests/test_training_plumbing.py.

The weights cross by checkpoint zip. The first three losses of each
solver must agree with JAX's within 1e-5 relative (the same line
searches over float32 vectors; the dot products sum in another order),
and 150 iterations must reach the JAX tests' accuracy floors. The oracle
keeps the flat vector and its gradient on the network's device as
float32 tensors, and the result lands in the live parameters.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.train import second_order as jso
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.train import second_order as tso
from deeplearning4j_tpu_torch.util import model_serializer as tser

LOSS_RTOL = 1e-5


def _mln():
    # small L2 keeps the full-batch optimizers out of sharp overfit
    # minima (the reference pairs these with regularization)
    return JNet(JaxBuilder.builder().set_seed(0)
                .updater(jupd.sgd(0.1)).l2(1e-3).list()
                .layer(jl.DenseLayer(n_out=12, activation="tanh"))
                .layer(jl.OutputLayer(n_out=3))
                .set_input_type(JIT.feed_forward(4)).build()).init()


def _graph():
    return JGraph(JaxBuilder.builder().set_seed(0)
                  .updater(jupd.sgd(0.1)).l2(1e-3).graph_builder()
                  .add_inputs("in")
                  .add_layer("h", jl.DenseLayer(n_out=12, activation="tanh"),
                             "in")
                  .add_layer("out", jl.OutputLayer(n_out=3), "h")
                  .set_outputs("out")
                  .set_input_types(JIT.feed_forward(4)).build()).init()


def _pair(tmp_path, make):
    jn = make()
    path = str(tmp_path / "net.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


# (network, algorithm, accuracy floor of the JAX tests)
CASES = {
    "lbfgs": (_mln, "lbfgs", 0.85),
    "conjugate_gradient": (_mln, "conjugate_gradient", 0.85),
    "line_gradient_descent": (_mln, "line_gradient_descent", 0.75),
    "lbfgs_on_graph": (_graph, "lbfgs", 0.85),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solver_follows_jax_and_fits_iris(tmp_path, case):
    make, algo, floor = CASES[case]
    xs, ys = iris_data()
    jn, tn = _pair(tmp_path, make)
    jhist = jso.optimize(jn, JDataSet(xs[:120], ys[:120]), algorithm=algo,
                         iterations=2)
    hist = tso.optimize(tn, TDataSet(xs[:120], ys[:120]), algorithm=algo,
                        iterations=150)
    np.testing.assert_allclose(hist[:3], jhist[:3], rtol=LOSS_RTOL)
    assert hist[-1] < hist[0] * 0.5, hist[:3] + hist[-3:]
    acc = tn.evaluate(TDataSet(xs[120:], ys[120:])).accuracy()
    assert acc > floor, acc


def test_the_oracle_stays_on_the_device_and_writes_back(tmp_path):
    xs, ys = iris_data()
    _, tn = _pair(tmp_path, _mln)
    ds = TDataSet(xs[:120], ys[:120])
    oracle, x0 = tso._flat_oracle(tn, ds)
    assert isinstance(x0, torch.Tensor) and x0.dtype == torch.float32
    assert x0.device == tn.device
    np.testing.assert_array_equal(x0.numpy(), tn.params_flat())
    loss, grad = oracle(x0)
    assert isinstance(grad, torch.Tensor) and grad.shape == x0.shape
    # the same loss and gradients as the executor's own training forward
    ref_loss, ref_grads, _ = tn._gradients(tn._batch_tuple(ds))
    from deeplearning4j_tpu_torch.util.tree import ordered_leaves
    ref = torch.cat([g.reshape(-1) for g in ordered_leaves(ref_grads)])
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    torch.testing.assert_close(grad, ref, rtol=1e-5, atol=1e-7)
    # the live parameters, not copies, receive the result
    live = list(tn.parameters())
    tso.optimize(tn, ds, algorithm="lbfgs", iterations=3)
    assert all(a is b for a, b in zip(live, tn.parameters()))
    assert not np.array_equal(tn.params_flat(), x0.numpy())


def test_unknown_algorithm_raises(tmp_path):
    xs, ys = iris_data()
    _, tn = _pair(tmp_path, _mln)
    with pytest.raises(ValueError, match="newton"):
        tso.optimize(tn, TDataSet(xs, ys), algorithm="newton")
