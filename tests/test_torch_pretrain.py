"""The port's embedding, pretraining, center-loss, frozen, VAE and YOLO
layers, the running-pool stream and layerwise pretraining against the
JAX package, on the CPU.

Seeded numpy inputs go through the JAX layer and the port's layer built
from the same config JSON: forward, and the gradients of the input and
of every param under one seeded cotangent. Tolerance: float32 on both
sides with sums in another order, atol=1e-5, rtol=1e-4 (as
``tests/test_torch_cnn.py``). Random draws cannot cross (torch cannot
replay ``jax.random``), so they are injected on both sides: the JAX
package's ``jax.random.bernoulli`` / ``jax.random.normal`` are replaced
by functions that return fixed uniforms' comparison / fixed normals, and
the port's ``uniform_draws`` / ``normal_draws`` by the same arrays. With
the draws injected, pretraining runs the same arithmetic in both
packages, and its params are held to JAX's after several SGD steps on
both executors. Stochastic pretraining (the port's own draws) must
lower its loss as the JAX package's tests require
(``tests/test_vae_yolo.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JaxNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    RBM, AutoEncoder, GlobalPoolingLayer, GravesLSTM, OutputLayer,
    RecursiveAutoEncoder, VariationalAutoencoder, layer_from_dict)
from deeplearning4j_tpu_torch.nn.conf.layers import core as tcore
from deeplearning4j_tpu_torch.nn.conf.layers import special as tspecial
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

ATOL, RTOL = 1e-5, 1e-4


def _np(a):
    return np.asarray(a, np.float32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _binary(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) > 0.5).astype(
        np.float32)


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            jser._flatten_with_paths(tree).items()}


def _tflat(tree):
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    return {k: np.asarray(v, np.float32) for k, v in _flatten(tree).items()}


def _assert_flat(port, ref, atol=ATOL, rtol=RTOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _pair(jax_layer, input_type, seed=0):
    """The JAX layer (shape-inferred, initialized), the port layer from
    its JSON, and the JAX params and state as numpy trees."""
    jax_layer.set_n_in(input_type)
    p, s = jax_layer.initialize(jax.random.PRNGKey(seed), input_type)
    port_layer = layer_from_dict(json.loads(json.dumps(jax_layer.to_dict())))
    return (jax_layer, port_layer, jax.tree_util.tree_map(_np, p),
            jax.tree_util.tree_map(_np, s))


def _leaves_t(tree):
    """A port params tree from numpy leaves, every leaf requiring grad."""
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), tree)


def _check_fn(jax_fn, port_fn, params, xs, *, x_grad=True, atol=ATOL,
              rtol=RTOL):
    """``jax_fn(params, *xs)`` and ``port_fn`` on the same numpy inputs:
    the outputs, and under one seeded cotangent the param gradients (and
    the first input's, with ``x_grad``)."""
    y_ref = jax_fn(params, *[jnp.asarray(a) for a in xs])
    ct = np.random.default_rng(1).standard_normal(np.shape(y_ref)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda p, *a: jax_fn(p, *a), params,
                     *[jnp.asarray(a) for a in xs])
    g_ref = vjp(jnp.asarray(ct))
    tp = _leaves_t(params)
    txs = [torch.tensor(a, requires_grad=(x_grad and i == 0))
           for i, a in enumerate(xs)]
    y = port_fn(tp, *txs)
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=atol,
                               rtol=rtol)
    leaves = list(jax.tree_util.tree_leaves(tp))
    wrt = leaves + ([txs[0]] if x_grad else [])
    grads = torch.autograd.grad(y, wrt, torch.tensor(ct), allow_unused=True)
    ref_leaves = jax.tree_util.tree_leaves(g_ref[0])
    for got, want in zip(grads[:len(leaves)], ref_leaves):
        got = np.zeros_like(_np(want)) if got is None else got.numpy()
        np.testing.assert_allclose(got, _np(want), atol=atol, rtol=rtol)
    if x_grad:
        np.testing.assert_allclose(grads[-1].numpy(), _np(g_ref[1]),
                                   atol=atol, rtol=rtol)


def p_t(tree):
    """A port params tree from numpy leaves (no grad)."""
    return jax.tree_util.tree_map(torch.tensor, tree)


def _check_apply(jax_layer, input_type, x, **kw):
    jlay, tlay, p, s = _pair(jax_layer, input_type)
    _check_fn(lambda pp, xx: jlay.apply(pp, s, xx)[0],
              lambda pp, xx: tlay.apply(pp, {}, xx)[0], p, [x], **kw)
    return jlay, tlay, p


@pytest.fixture
def inject_draws(monkeypatch):
    """Make both packages draw ``U`` (uniforms, for Bernoulli samples)
    and the normals of ``E`` in order: returns a setter (U, E). Before
    it is called (weight init) both draw as usual."""
    box = {"U": None, "E": None}
    bernoulli, normal = jax.random.bernoulli, jax.random.normal

    def jax_bernoulli(key, p=0.5, shape=None):
        if box["U"] is None:
            return bernoulli(key, p, shape)
        return jnp.asarray(box["U"]) < p

    def jax_normal(key, shape=(), dtype=jnp.float32):
        if box["E"] is None:
            return normal(key, shape, dtype)
        e = box["E"][box["j"] % len(box["E"])]
        box["j"] += 1
        return jnp.asarray(e, dtype)

    def port_uniform(shape, generator, device):
        assert tuple(shape) == box["U"].shape
        return torch.tensor(box["U"], device=device)

    def port_normal(shape, generator, device):
        e = box["E"][box["t"] % len(box["E"])]
        box["t"] += 1
        return torch.tensor(e, device=device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(tcore, "uniform_draws", port_uniform)
    monkeypatch.setattr(tspecial, "normal_draws", port_normal)

    def set_draws(U=None, E=None):
        box.update(U=U, E=E, j=0, t=0)
    return set_draws


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("ids_shape", [(6,), (6, 1)])
def test_embedding_layer_matches_jax(ids_shape):
    ids = np.random.default_rng(0).integers(0, 9, ids_shape).astype(
        np.float32)
    _check_apply(jl.EmbeddingLayer(n_in=9, n_out=5, activation="tanh"),
                 JIT.feed_forward(9), ids, x_grad=False)


def test_rbm_apply_and_free_energy_match_jax():
    x = _binary((5, 7))
    jlay, tlay, p = _check_apply(jl.RBM(n_out=4), JIT.feed_forward(7), x)
    _check_fn(lambda pp, v: jlay._free_energy(pp, v),
              lambda pp, v: tlay._free_energy(pp, v), p, [x])


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_cd_loss_with_injected_hiddens_matches_jax(visible,
                                                       inject_draws):
    x = _binary((6, 7))
    jlay, tlay, p, _ = _pair(jl.RBM(n_out=4, k=2, visible_unit=visible),
                             JIT.feed_forward(7))
    inject_draws(U=np.random.default_rng(3).random((6, 4)).astype(
        np.float32))

    def port_loss(pp, xx):
        v = xx
        for _ in range(tlay.k):
            v = tlay._gibbs(pp, v, None)
        return tlay._cd_loss(pp, xx, v)
    _check_fn(lambda pp, xx: jlay.pretrain_loss(pp, xx,
                                                jax.random.PRNGKey(0)),
              port_loss, p, [x], x_grad=False)
    np.testing.assert_allclose(
        float(tlay.reconstruction_error(p_t(p), torch.tensor(x), None)),
        float(jlay.reconstruction_error(p, x, jax.random.PRNGKey(0))),
        atol=ATOL, rtol=RTOL)


def test_rbm_refusals_keep_the_jax_messages():
    with pytest.raises(ValueError, match="sigmoid"):
        RBM(n_out=4, activation="relu")
    with pytest.raises(ValueError, match="visible_unit"):
        RBM(n_out=4, visible_unit="Binary")
    with pytest.raises(ValueError, match="hidden_unit"):
        RBM(n_out=4, hidden_unit="gaussian")


@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_matches_jax(corruption, inject_draws):
    x = _x((6, 7))
    jlay, tlay, p = _check_apply(
        jl.AutoEncoder(n_out=4, activation="tanh",
                       corruption_level=corruption),
        JIT.feed_forward(7), x)
    U = np.random.default_rng(4).random((6, 7)).astype(np.float32)
    inject_draws(U=U)
    keep = torch.tensor(U < 1.0 - corruption) if corruption else None
    _check_fn(lambda pp, xx: jlay.pretrain_loss(pp, xx,
                                                jax.random.PRNGKey(0)),
              lambda pp, xx: tlay._recon_loss(pp, xx, keep), p, [x])
    # the port's own pretrain_loss takes the same (injected) draws
    np.testing.assert_allclose(
        float(tlay.pretrain_loss(p_t(p), torch.tensor(x),
                                 torch.Generator())),
        float(jlay.pretrain_loss(p, x, jax.random.PRNGKey(0))),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_recursive_autoencoder_fold_matches_jax(masked):
    x = _x((3, 5, 4))
    mask = (np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 0, 0, 0, 0]],
                     np.float32) if masked else None)
    jlay, tlay, p, _ = _pair(
        jl.RecursiveAutoEncoder(n_out=6, activation="tanh"),
        JIT.recurrent(4, 5))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    _check_fn(lambda pp, xx: jlay.apply(pp, {}, xx, mask=jm)[0],
              lambda pp, xx: tlay.apply(pp, {}, xx, mask=tm)[0], p, [x])
    _check_fn(lambda pp, xx: jlay.pretrain_loss(pp, xx, None, mask=jm),
              lambda pp, xx: tlay.pretrain_loss(pp, xx, None, mask=tm),
              p, [x])


def test_center_loss_and_update_centers_match_jax():
    x = _x((6, 5))
    labels = np.eye(4, dtype=np.float32)[[0, 2, 2, 1, 0, 2]]  # no class 3
    jlay, tlay, p, s = _pair(
        jl.CenterLossOutputLayer(n_out=4, alpha=0.3, lambda_=0.5),
        JIT.feed_forward(5))
    s = {"centers": _x((4, 5), seed=2)}
    ts = {"centers": torch.tensor(s["centers"])}
    _check_fn(lambda ss, xx: jlay.center_loss(ss, xx, jnp.asarray(labels)),
              lambda ss, xx: tlay.center_loss(ss, xx, torch.tensor(labels)),
              s, [x])
    new = tlay.update_centers(ts, torch.tensor(x), torch.tensor(labels))
    ref = jlay.update_centers(s, jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(new["centers"].numpy(), _np(ref["centers"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(new["centers"][3].numpy(),
                                  s["centers"][3])   # absent: kept
    _check_fn(lambda pp, xx: jlay.loss_from_input(
                  pp, xx, jnp.asarray(labels), training=False, rng=None),
              lambda pp, xx: tlay.loss_from_input(
                  pp, xx, torch.tensor(labels)), p, [x])


def test_frozen_layer_matches_its_inner_layer_and_passes_no_gradient():
    x = _x((4, 6))
    inner = jl.DenseLayer(n_out=3, activation="tanh", dropout=0.5)
    jlay, tlay, p, _ = _pair(jl.FrozenLayer(inner=inner),
                             JIT.feed_forward(6))
    assert tlay.to_dict() == jlay.to_dict()
    tp = _leaves_t(p)
    xt = torch.tensor(x, requires_grad=True)
    # training=True still runs the inner layer at inference (no dropout)
    y, _ = tlay.apply(tp, {}, xt, training=True,
                      generator=torch.Generator())
    y_ref, _ = jlay.apply(p, {}, jnp.asarray(x), training=True,
                          rng=jax.random.PRNGKey(0))
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL,
                               rtol=RTOL)
    gx, = torch.autograd.grad(y.sum(), [xt])
    assert gx.abs().sum() > 0
    assert all(torch.autograd.grad(y.sum(), [v], allow_unused=True)[0]
               is None for v in tp.values())


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian", "exponential"])
def test_vae_apply_elbo_and_reconstruction_probability_match_jax(
        dist, inject_draws):
    x = _binary((5, 8)) if dist == "bernoulli" else np.abs(_x((5, 8)))
    jlay, tlay, p = _check_apply(
        jl.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(7, 6),
                                  decoder_layer_sizes=(6,),
                                  reconstruction_distribution=dist,
                                  num_samples=2),
        JIT.feed_forward(8), x)
    E = _x((5, 5, 3), seed=7)
    inject_draws(E=E[:2])           # num_samples draws a loss
    _check_fn(lambda pp, xx: jlay.pretrain_loss(pp, xx,
                                                jax.random.PRNGKey(0)),
              lambda pp, xx: tlay._elbo(pp, xx, torch.tensor(E[:2])),
              p, [x])
    inject_draws(E=E)
    ref = jlay.reconstruction_probability(p, jnp.asarray(x),
                                          jax.random.PRNGKey(1),
                                          num_samples=5)
    got = tlay.reconstruction_probability(p_t(p), torch.tensor(x),
                                          eps=torch.tensor(E))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL,
                               rtol=RTOL)
    z = _x((4, 3), seed=8)
    np.testing.assert_allclose(
        tlay.generate(p_t(p), torch.tensor(z)).numpy(),
        _np(jlay.generate(p, jnp.asarray(z))), atol=ATOL, rtol=RTOL)


def test_vae_unknown_distribution_is_refused():
    vae = VariationalAutoencoder(n_in=4, n_out=2,
                                 reconstruction_distribution="poisson")
    with pytest.raises(ValueError, match="poisson"):
        vae._reconstruction_logprob(torch.zeros(1, 4), torch.zeros(1, 4))


def _yolo_target(rng, b, g, a, c):
    t = np.zeros((b, g, g, a * (5 + c)), np.float32)
    for i in range(b):
        gx, gy = rng.integers(0, g, 2)
        base = rng.integers(0, a) * (5 + c)
        t[i, gy, gx, base:base + 2] = rng.random(2)
        t[i, gy, gx, base + 2:base + 4] = 0.5 + rng.random(2)
        t[i, gy, gx, base + 4] = 1.0
        t[i, gy, gx, base + 5 + rng.integers(0, c)] = 1.0
    return t


def test_yolo2_apply_and_loss_match_jax():
    g, a, c = 4, 2, 3
    x = _x((3, g, g, a * (5 + c)))
    t = _yolo_target(np.random.default_rng(5), 3, g, a, c)
    jlay, tlay, p = _check_apply(
        jl.Yolo2OutputLayer(anchors=((1.0, 1.5), (2.0, 1.0))),
        JIT.convolutional(g, g, a * (5 + c)), x)
    _check_fn(lambda pp, xx: jlay.loss_from_input(
                  pp, xx, jnp.asarray(t), training=True, rng=None),
              lambda pp, xx: tlay.loss_from_input(pp, xx, torch.tensor(t),
                                                  training=True),
              p, [x])


# ------------------------------------------------------- apply_stream

@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_stream_matches_jax(pooling):
    x = _x((2, 7, 3))
    jlay = jl.GlobalPoolingLayer(pooling=pooling, pnorm=3)
    tlay = layer_from_dict(jlay.to_dict())
    jc = tc = None
    for lo, hi in ((0, 1), (1, 4), (4, 5), (5, 7)):
        jy, jc = jlay.apply_stream({}, jc, jnp.asarray(x[:, lo:hi]))
        ty, tc = tlay.apply_stream({}, tc, torch.tensor(x[:, lo:hi]))
        np.testing.assert_allclose(ty.numpy(), _np(jy), atol=ATOL,
                                   rtol=RTOL)
    full, _ = tlay.apply({}, {}, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="TIME"):
        tlay.apply_stream({}, None, torch.zeros(2, 3))


def _pool_net(pooling, device="cpu"):
    conf = (NeuralNetConfiguration.builder().set_seed(0).list()
            .layer(GravesLSTM(n_out=6, activation="tanh"))
            .layer(GlobalPoolingLayer(pooling=pooling))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(4, 9)).build())
    return MultiLayerNetwork(conf, device=device).init()


@pytest.mark.parametrize("pooling", ["avg", "max", "pnorm"])
def test_pooled_stream_equals_output_over_each_prefix(pooling):
    net = _pool_net(pooling)
    x = _x((2, 9, 4))
    sess = net.streaming_session(capacity=9, batch=2)
    for t in range(9):
        want = net.output(x[:, :t + 1]).numpy()
        np.testing.assert_allclose(net.rnn_time_step(x[:, t]).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(sess.step(x[:, t]).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
    sess.reset()
    np.testing.assert_allclose(sess.step(x[:, 0]).numpy(),
                               net.output(x[:, :1]).numpy(), atol=ATOL,
                               rtol=RTOL)


def test_pooled_stream_on_a_graph_and_the_slot_session_refusal():
    net = _pool_net("avg")
    with pytest.raises(ValueError, match="running statistic"):
        net.slot_streaming_session(capacity=4, slots=2)
    conf = (NeuralNetConfiguration.builder().set_seed(0).graph_builder()
            .add_inputs("in").set_input_types(InputType.recurrent(4, 5))
            .add_layer("lstm", GravesLSTM(n_out=6, activation="tanh"), "in")
            .add_layer("pool", GlobalPoolingLayer(pooling="max"), "lstm")
            .add_layer("out", OutputLayer(n_out=3), "pool")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu").init()
    x = _x((2, 5, 4))
    sess = g.streaming_session(capacity=5, batch=2)
    for t in range(5):
        want = g.output(x[:, :t + 1]).numpy()
        np.testing.assert_allclose(g.rnn_time_step(x[:, t]).numpy(), want,
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(sess.step(x[:, t]).numpy(), want,
                                   atol=ATOL, rtol=RTOL)


# ------------------------------------------------- layerwise pretrain

def _mln_pair(layers, input_type, lr=0.1, seed=0):
    """(JAX net, port net with its params) for ``layers``, a function
    of the layers module, the input type, sgd(lr)."""
    def build(builder, mod, it, upd):
        b = builder.builder().set_seed(seed).updater(upd.sgd(lr)).list()
        for lay in layers(mod):
            b = b.layer(lay)
        return b.set_input_type(input_type(it)).build()
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    jn = JaxNet(build(JaxBuilder, jl, JIT, jupd)).init()
    tc = build(NeuralNetConfiguration, tl, InputType, tupd)
    assert tc.to_json() == jn.conf.to_json()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(tc.to_json()),
                           device="cpu").init()
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    return jn, tn


@pytest.mark.parametrize("kind", ["ae", "rae", "rbm", "vae"])
def test_deterministic_pretraining_matches_jax_on_multilayer(
        kind, inject_draws):
    """Five SGD steps a layer (two epochs over 2-3 batches) with the
    draws injected: every layer's params after ``pretrain`` equal
    JAX's."""
    if kind == "rae":
        x = _x((12, 5, 4))
        layers = (lambda m: [m.RecursiveAutoEncoder(n_out=6,
                                                    activation="tanh"),
                             m.OutputLayer(n_out=2)])
        it = (lambda I: I.recurrent(4, 5))
    else:
        x = _binary((12, 9)) if kind in ("rbm", "vae") else _x((12, 9))
        first = {"ae": lambda m: m.AutoEncoder(n_out=6, activation="tanh",
                                               corruption_level=0.0),
                 "rbm": lambda m: m.RBM(n_out=6),
                 "vae": lambda m: m.VariationalAutoencoder(
                     n_out=3, encoder_layer_sizes=(7,),
                     decoder_layer_sizes=(7,))}[kind]
        layers = (lambda m: [m.DenseLayer(n_out=8, activation="sigmoid"),
                             first(m), m.AutoEncoder(
                                 n_out=4, activation="sigmoid",
                                 corruption_level=0.0),
                             m.OutputLayer(n_out=2)])
        it = (lambda I: I.feed_forward(9))
    jn, tn = _mln_pair(layers, it)
    start = _flat(jn.params)
    inject_draws(U=np.random.default_rng(6).random((4, 6)).astype(
        np.float32), E=_x((1, 4, 3), seed=9))
    jn.pretrain(JaxDataSet(x), epochs=2, batch_size=4)
    tn.pretrain(DataSet(x), epochs=2, batch_size=4)
    moved = _flat(jn.params)
    _assert_flat(_tflat(tn.params), moved)
    pretrained = 0 if kind == "rae" else 1
    assert any(not np.allclose(moved[k], start[k])
               for k in moved if k.startswith(f"{pretrained}/"))


def test_deterministic_pretraining_matches_jax_on_a_graph():
    """An AutoEncoder vertex (corruption 0) after a dense vertex, and a
    second input's branch the vertex does not need: ``pretrain``'s
    params equal JAX's; only the ancestors of the vertex's input run."""
    def build(builder, mod, it, upd):
        return (builder.builder().set_seed(0).updater(upd.sgd(0.2))
                .graph_builder().add_inputs("a", "b")
                .set_input_types(it.feed_forward(6), it.feed_forward(3))
                .add_layer("d", mod.DenseLayer(n_out=5, activation="tanh"),
                           "a")
                .add_layer("ae", mod.AutoEncoder(
                    n_out=4, activation="sigmoid", corruption_level=0.0),
                    "d")
                .add_layer("side", mod.DenseLayer(n_out=2), "b")
                .add_vertex("cat", _merge(mod), "ae", "side")
                .add_layer("out", mod.OutputLayer(n_out=2), "cat")
                .set_outputs("out").build())
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    jg = JaxGraph(build(JaxBuilder, jl, JIT, jupd)).init()
    tc = build(NeuralNetConfiguration, tl, InputType, tupd)
    assert tc.to_json() == jg.conf.to_json()
    tg = ComputationGraph(ComputationGraphConfiguration.from_json(
        tc.to_json()), device="cpu").init()
    tg.set_params(params_from_jax(jax.device_get(jg.params), device="cpu"))
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS

    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    xa, xb = _x((8, 6)), _x((8, 3), seed=1)
    batches = [(xa[i:i + 4], xb[i:i + 4]) for i in (0, 4)]
    jg.pretrain([JaxMDS([a, b], [None]) for a, b in batches], epochs=3)
    ran = []
    forward = tg._forward

    def spy(*a, **kw):
        ran.append(kw.get("only"))
        return forward(*a, **kw)
    tg._forward = spy
    tg.pretrain([MultiDataSet([a, b], [None]) for a, b in batches],
                epochs=3)
    assert ran and all(o == {"d"} for o in ran)
    _assert_flat(_tflat(tg.params), _flat(jg.params))


def _merge(mod):
    if mod is jl:
        from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    else:
        from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    return MergeVertex()


def _two_cluster_binary(rng, n=256, flip_p=0.1):
    protos = (rng.random((2, 12)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 2, n)
    flips = rng.random((n, 12)) < flip_p
    return np.abs(protos[labels] - flips.astype(np.float32))


def _net(first, n_in=12, updater=None, it=None, seed=0):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updater or tupd.adam(1e-2)).list()
            .layer(first).layer(OutputLayer(n_out=2))
            .set_input_type(it or InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_stochastic_pretraining_improves_vae_elbo():
    x = _two_cluster_binary(np.random.default_rng(0))
    vae = VariationalAutoencoder(n_out=4, encoder_layer_sizes=(16,),
                                 decoder_layer_sizes=(16,))
    net = _net(vae)
    xt = torch.tensor(x[:64])

    def loss():
        return float(vae.pretrain_loss(net.params[0], xt,
                                       torch.Generator().manual_seed(0)))
    loss0 = loss()
    net.pretrain(DataSet(x), epochs=30, batch_size=64)
    assert loss() < loss0 * 0.8


def test_stochastic_pretraining_improves_rbm_reconstruction():
    x = _two_cluster_binary(np.random.default_rng(0), flip_p=0.05)
    rbm = RBM(n_out=8, k=1)
    net = _net(rbm, updater=tupd.sgd(0.1))
    xt = torch.tensor(x[:64])

    def err():
        return float(rbm.reconstruction_error(
            net.params[0], xt, torch.Generator().manual_seed(0)))
    err0 = err()
    net.pretrain(DataSet(x), epochs=60, batch_size=64)
    assert err() < err0 * 0.7


def test_stochastic_pretraining_improves_autoencoder_and_rae():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (128, 10)).astype(np.float32)
    ae = AutoEncoder(n_out=6, corruption_level=0.2, activation="tanh")
    net = _net(ae, n_in=10, seed=2)
    g = torch.Generator().manual_seed(0)
    l0 = float(ae.pretrain_loss(net.params[0], torch.tensor(x), g))
    net.pretrain(DataSet(x), epochs=40, batch_size=64)
    g = torch.Generator().manual_seed(0)
    assert float(ae.pretrain_loss(net.params[0], torch.tensor(x), g)) < \
        l0 * 0.8
    xs = rng.normal(0, 1, (64, 6, 8)).astype(np.float32)
    rae = RecursiveAutoEncoder(n_in=8, n_out=8, activation="tanh")
    net = _net(rae, it=InputType.recurrent(8, 6), seed=2)
    l0 = float(rae.pretrain_loss(net.params[0], torch.tensor(xs)))
    net.pretrain(DataSet(xs), epochs=40, batch_size=32)
    assert float(rae.pretrain_loss(net.params[0], torch.tensor(xs))) < \
        l0 * 0.8
    assert net.output(xs[:4]).shape == (4, 2)


def test_center_loss_fit_step_matches_jax_on_multilayer():
    """One nesterovs step of a dense net with a center-loss head: the
    loss, the params and the new centers equal JAX's."""
    def layers(m):
        return [m.DenseLayer(n_out=6, activation="tanh"),
                m.CenterLossOutputLayer(n_out=3, alpha=0.5, lambda_=0.3)]
    jn, tn = _mln_pair(layers, lambda I: I.feed_forward(5))
    x = _x((8, 5))
    y = np.eye(3, dtype=np.float32)[[0, 1, 1, 0, 0, 1, 0, 1]]
    jn.fit(JaxDataSet(x, y))
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    tn.fit(DataSet(x, y))
    np.testing.assert_allclose(float(tn.score_value),
                               float(jn.score_value), atol=ATOL, rtol=RTOL)
    _assert_flat(_tflat(tn.params), _flat(jn.params))
    _assert_flat(_tflat(tn.state), _flat(jn.state))
    assert np.abs(_tflat(tn.state)["1/centers"][2]).max() == 0  # absent


# ------------------------------------------------------------ card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pretraining_on_the_card_matches_the_cpu(cuda_device,
                                                  inject_draws):
    def layers(m):
        return [m.RBM(n_out=6), m.VariationalAutoencoder(
            n_out=3, encoder_layer_sizes=(7,), decoder_layer_sizes=(7,)),
            m.OutputLayer(n_out=2)]
    _, cpu = _mln_pair(layers, lambda I: I.feed_forward(9))
    card = MultiLayerNetwork(cpu.conf.clone(), device="cuda").init()
    card.set_params(cpu.params)
    inject_draws(U=np.random.default_rng(6).random((4, 6)).astype(
        np.float32), E=_x((1, 4, 3), seed=9))
    x = _binary((12, 9))
    cpu.pretrain(DataSet(x), epochs=2, batch_size=4)
    card.pretrain(DataSet(x), epochs=2, batch_size=4)
    _assert_flat(_tflat(card.params), _tflat(cpu.params))
