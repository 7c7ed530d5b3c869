"""The port's gradient check (``deeplearning4j_tpu_torch/gradientcheck.py``)
against the JAX package's, on every config of tests/test_gradientcheck.py
and the transformer block of tests/test_native_and_kernels.py.

The weights cross by checkpoint zip. For each config: the port's flat
float64 parameter vector equals the JAX one entry for entry (so a seeded
``subset`` draws the same parameters), the port's float64 analytic
gradient (autograd) agrees with ``jax.grad`` in float64 at the same
parameters within 1e-10 of the largest entry, and the port's own
numerical check passes. The JAX numerical loop is not run here (it is
slow; tests/test_gradientcheck.py runs it). A planted wrong backward (an
autograd Function scaling one gradient by 1.5) must make the check fail.

float64 attention: ``flash_attention`` sends float64 q, k, v to the
plain forward on either device (keyed on the dtype), held here against
the float32 plain version; the card test holds the float32
kernel route and the float64 route on one card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import gradientcheck as jgc
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import gradientcheck as tgc
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet as TMultiDataSet
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.util import model_serializer as tser

GRAD_RTOL = 1e-10


def _data(n=8, fin=4, fout=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, fin))
    y = np.eye(fout)[rng.integers(0, fout, n)]
    return x, y, None


def _mln(layers, input_type, l1=0.0, l2=0.0, seed=3):
    b = JaxBuilder.builder().set_seed(seed).l1(l1).l2(l2).list()
    for layer in layers:
        b = b.layer(layer)
    return JNet(b.set_input_type(input_type).build()).init()


def _seq(seed, shape, classes, mask=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape)
    y = np.eye(classes)[rng.integers(0, classes, shape[:2])]
    return x, y, mask


def _graves():
    net = _mln([jl.GravesLSTM(n_out=4),
                jl.RnnOutputLayer(n_out=2, loss="mcxent")],
               JIT.recurrent(3, 5))
    # peephole weights start at 0; perturb so their grads are visible
    rng = np.random.default_rng(4)
    rng.normal(0, 1, (4, 5, 3))
    rng.integers(0, 2, (4, 5))
    net.params[0]["wc"] = jnp.asarray(
        rng.normal(0, 0.1, net.params[0]["wc"].shape), jnp.float32)
    return net


def _lstm_mask():
    mask = np.ones((4, 6))
    mask[2:, 4:] = 0
    return _seq(5, (4, 6, 3), 2, mask)


def _two_branch():
    g = (JaxBuilder.builder().set_seed(5).graph_builder()
         .add_inputs("in")
         .add_layer("a", jl.DenseLayer(n_out=4, activation="tanh"), "in")
         .add_layer("b", jl.DenseLayer(n_out=4, activation="sigmoid"), "in")
         .add_vertex("add", ElementWiseVertex(op="add"), "a", "b")
         .add_vertex("cat", MergeVertex(), "add", "a")
         .add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent"), "cat")
         .set_outputs("out").set_input_types(JIT.feed_forward(4)).build())
    return JGraph(g).init()


def _multi_output():
    g = (JaxBuilder.builder().set_seed(6).graph_builder()
         .add_inputs("in")
         .add_layer("h", jl.DenseLayer(n_out=6, activation="tanh"), "in")
         .add_layer("out1", jl.OutputLayer(n_out=3, loss="mcxent"), "h")
         .add_layer("out2", jl.OutputLayer(n_out=2, loss="mse",
                                           activation="identity"), "h")
         .set_outputs("out1", "out2")
         .set_input_types(JIT.feed_forward(4)).build())
    return JGraph(g).init()


def _multi_data():
    rng = np.random.default_rng(7)
    return ([rng.normal(0, 1, (6, 4))],
            [np.eye(3)[rng.integers(0, 3, 6)], rng.normal(0, 1, (6, 2))])


def _cnn_data():
    rng = np.random.default_rng(1)
    return (rng.normal(0, 1, (4, 6, 6, 2)),
            np.eye(3)[rng.integers(0, 3, 4)], None)


def _block_data():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (4, 6, 8)), np.eye(2)[rng.integers(0, 2, 4)],
            None)


# name: (JAX network, data, subset)
CASES = {
    "dense_softmax": (lambda: _mln(
        [jl.DenseLayer(n_out=5, activation="tanh"),
         jl.OutputLayer(n_out=3, loss="mcxent")], JIT.feed_forward(4)),
        _data, None),
    "dense_with_l1_l2": (lambda: _mln(
        [jl.DenseLayer(n_out=5, activation="sigmoid"),
         jl.OutputLayer(n_out=3, loss="mcxent")], JIT.feed_forward(4),
        l1=1e-2, l2=1e-2), _data, None),
    "mse_identity": (lambda: _mln(
        [jl.DenseLayer(n_out=5, activation="relu"),
         jl.OutputLayer(n_out=3, loss="mse", activation="identity")],
        JIT.feed_forward(4)), _data, None),
    "cnn": (lambda: _mln(
        [jl.ConvolutionLayer(n_out=3, kernel=(3, 3), activation="tanh"),
         jl.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
         jl.OutputLayer(n_out=3, loss="mcxent")],
        JIT.convolutional(6, 6, 2)), _cnn_data, None),
    "lstm": (lambda: _mln(
        [jl.LSTM(n_out=4), jl.RnnOutputLayer(n_out=2, loss="mcxent")],
        JIT.recurrent(3, 5)), lambda: _seq(2, (4, 5, 3), 2), None),
    "graves_lstm_peepholes": (_graves, lambda: _seq(4, (4, 5, 3), 2), None),
    "lstm_masked": (lambda: _mln(
        [jl.LSTM(n_out=4), jl.RnnOutputLayer(n_out=2, loss="mcxent")],
        JIT.recurrent(3, 6)), _lstm_mask, None),
    "batchnorm": (lambda: _mln(
        [jl.DenseLayer(n_out=5, activation="identity"),
         jl.BatchNormalization(), jl.OutputLayer(n_out=3, loss="mcxent")],
        JIT.feed_forward(4)), _data, None),
    "two_branch_graph": (_two_branch, _data, None),
    "multi_output_graph": (_multi_output, _multi_data, None),
    "transformer_block": (lambda: _mln(
        [jl.TransformerEncoderLayer(n_heads=2, ffn_multiplier=2),
         jl.GlobalPoolingLayer(pooling="avg"), jl.OutputLayer(n_out=2)],
        JIT.recurrent(8, 6), seed=1), _block_data, 150),
}


def _datasets(data):
    if len(data) == 2:                       # multi-output graph
        xs, ys = data
        return JMultiDataSet(xs, ys), TMultiDataSet(xs, ys)
    x, y, mask = data
    return (JDataSet(x, y, features_mask=mask, labels_mask=mask),
            TDataSet(x, y, features_mask=mask, labels_mask=mask))


def _jax_flat_grad(net, ds):
    """jax.grad of the JAX package's float64 flat loss, as its
    ``check_gradients`` builds it (both executors)."""
    with jgc._x64_policy():
        to64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa
        params = jax.tree_util.tree_map(to64, net.params)
        state = jax.tree_util.tree_map(to64, net.state)
        if isinstance(net, JGraph):
            mds = net._as_multi(ds)
            batch = (tuple(to64(f) for f in mds.features),
                     tuple(to64(y) for y in mds.labels), None, None)
        else:
            batch = tuple(None if a is None else to64(a)
                          for a in net._batch_tuple(ds))
        leaves, treedef = jax.tree_util.tree_flatten(params)
        flat0 = jnp.concatenate([l.ravel() for l in leaves])

        def loss_flat(flat):
            out, off = [], 0
            for leaf in leaves:
                out.append(flat[off:off + leaf.size].reshape(leaf.shape))
                off += leaf.size
            loss, _ = net._loss(jax.tree_util.tree_unflatten(treedef, out),
                                state, batch, None, training=False)
            return loss
        return (np.asarray(flat0),
                np.asarray(jax.jit(jax.grad(loss_flat))(flat0)))


def _pair(tmp_path, make):
    jn = make()
    path = str(tmp_path / "net.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_float64_gradients_equal_jax_and_the_check_passes(tmp_path, case):
    make, data, subset = CASES[case]
    jn, tn = _pair(tmp_path, make)
    jds, tds = _datasets(data())
    jflat, jgrad = _jax_flat_grad(jn, jds)
    flat0, loss_of = tgc.flat_loss(tn, tds)
    assert flat0.dtype == torch.float64
    # the same flat order: a seeded subset draws the same parameters
    np.testing.assert_array_equal(flat0.numpy(), jflat)
    flat = flat0.clone().requires_grad_(True)
    grad = torch.autograd.grad(loss_of(flat), flat)[0].numpy()
    err = np.abs(grad - jgrad).max()
    assert err <= GRAD_RTOL * np.abs(jgrad).max(), (case, err)
    rep = tgc.gradient_check_report(tn, tds, subset=subset)
    assert rep["ok"] and rep["failures"] == 0
    assert rep["params"] == (subset or flat0.numel())
    if isinstance(jn, JGraph):
        assert tgc.check_gradients_graph(tn, tds)


def test_the_check_leaves_the_network_as_it_was(tmp_path):
    """float32 parameters and state, the same tensors, after a check."""
    jn, tn = _pair(tmp_path, CASES["batchnorm"][0])
    before = [p for p in tn.parameters()]
    values = [p.detach().clone() for p in before]
    state = [dict(s) for s in tn.state]
    assert tgc.check_gradients(tn, _datasets(_data())[1])
    after = list(tn.parameters())
    assert all(a is b for a, b in zip(before, after))
    for p, v in zip(after, values):
        assert p.dtype == torch.float32 and torch.equal(p, v)
    for s0, s1 in zip(state, tn.state):
        for k in s0:
            assert s1[k] is s0[k] and s1[k].dtype == torch.float32


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by 1.5."""

    @staticmethod
    def forward(ctx, w):
        return w.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


def test_a_wrong_backward_is_caught(tmp_path, monkeypatch):
    _, tn = _pair(tmp_path, CASES["dense_softmax"][0])
    ds = _datasets(_data())[1]
    assert tgc.check_gradients(tn, ds)
    layer = tn.layers[0]
    apply = layer.apply

    def wrong(params, *a, **kw):
        params = dict(params, W=_ScaleGrad.apply(params["W"]))
        return apply(params, *a, **kw)
    monkeypatch.setattr(layer, "apply", wrong)
    assert not tgc.check_gradients(tn, ds)
    # every W entry whose gradient is not ~0 fails (|1.5g - g| / 2.5|g|);
    # b passes
    rep = tgc.gradient_check_report(tn, ds)
    assert rep["failures"] > 0 and not rep["ok"]
    assert rep["max_rel_error"] == pytest.approx(0.2, rel=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_float64_attention_takes_the_plain_route(masked):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, 2, 32)))
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.ones(2, 16)
        mask[1, 9:] = 0
    o64 = tattn.flash_attention(q, k, v, causal=True, kv_mask=mask)
    assert o64.dtype == torch.float64
    o32, _ = tattn.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), mask, causal=True)
    np.testing.assert_allclose(o64.numpy(), o32.numpy(), atol=2e-6)
    # differentiable through autograd, no float32 on the way
    qg = q.clone().requires_grad_(True)
    out = tattn.flash_attention(qg, k, v, causal=True, kv_mask=mask)
    g, = torch.autograd.grad(out.sum(), qg)
    assert g.dtype == torch.float64 and torch.isfinite(g).all()
    o64_plain, _ = tattn.flash_attention_fwd_plain(q, k, v, mask,
                                                   causal=True)
    assert torch.equal(o64, o64_plain)
    # the kernel's wrapper still takes float32 alone on a card
    with pytest.raises(TypeError, match="float32"):
        tattn.flash_attention_fwd_cuda(q, k, v, causal=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_card_float32_takes_the_kernel_float64_the_plain_route(card):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 128, 4, 64)))
               .to(card) for _ in range(3))
    fwd = tattn.flash_attention_fwd_cuda
    fwd.launches = 0
    o32 = tattn.flash_attention(q.float(), k.float(), v.float(),
                                causal=True)
    torch.cuda.synchronize()
    assert fwd.launches == 1 and o32.dtype == torch.float32
    o64 = tattn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fwd.launches == 1 and o64.dtype == torch.float64
    np.testing.assert_allclose(o32.cpu().numpy(), o64.cpu().numpy(),
                               atol=2e-5)
    # the float64 gradient check of the transformer block on the card
    # (built by the port's own builder: nothing of JAX runs here)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    conf = (NeuralNetConfiguration.builder().set_seed(1).list()
            .layer(tl.TransformerEncoderLayer(n_heads=2, ffn_multiplier=2))
            .layer(tl.GlobalPoolingLayer(pooling="avg"))
            .layer(tl.OutputLayer(n_out=2))
            .set_input_type(InputType.recurrent(64, 8)).build())
    tn = MultiLayerNetwork(conf, device=card).init()
    x = rng.normal(0, 1, (4, 8, 64))
    y = np.eye(2)[rng.integers(0, 2, 4)]
    assert tgc.check_gradients(tn, TDataSet(x, y), subset=100)
    assert fwd.launches == 1
