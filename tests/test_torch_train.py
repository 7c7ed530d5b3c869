"""The port's training path against the JAX package's, on the CPU.

A small transformer LM (V=64, D=32, L=2, H=4, T=16, as in
tests/test_torch_lm.py) is built with the JAX builder and
``updater(adam(1e-3))``, saved with the JAX ``write_model`` and restored
by the port; the same seeded numpy ids and one-hot labels go to both.
On the CPU the port's attention takes its plain forward and backward;
the JAX package takes its blockwise / exact masked attention and their
VJPs.

Tolerances, float32 on both sides with sums in another order:
- score and gradients: atol 2e-6 (gradients are O(1e-2) and below),
  rtol 2e-4;
- parameters after Adam steps: Adam's first step is about lr*sign(g),
  so a gradient that differs in its last bits moves a parameter by up
  to ~lr*|dg/g|; parameters are held to atol lr/20 = 5e-5 (a twentieth
  of one step) and rtol 2e-4;
- the update rules on a random tree: atol 1e-6, rtol 1e-5.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import (
    ArrayDataSetIterator as JaxArrayIterator)
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.train import constraints as jcons
from deeplearning4j_tpu.train import gradnorm as jgn
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (ArrayDataSetIterator,
                                                     ListDataSetIterator)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.layers import base as tbase
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.train import constraints as tcons
from deeplearning4j_tpu_torch.train import gradnorm as tgn
from deeplearning4j_tpu_torch.util import model_serializer as tser

V, D, L, H, T, B = 64, 32, 2, 4, 16, 3
LR = 1e-3
ATOL, RTOL = 2e-6, 2e-4
P_ATOL = LR / 20


def _jax_lm(updater=None, out_kw=None, clip=None):
    b = NeuralNetConfiguration.builder().set_seed(0)
    b = b.updater(updater or jupd.adam(LR))
    if clip is not None:
        b = b.clip_gradient_norm(clip)
    b = b.list().layer(EmbeddingSequenceLayer(n_in=V, n_out=D))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent",
                                   **(out_kw or {})))
            .set_input_type(JaxInputType.recurrent(V, T)).build())
    return JaxNet(conf).init()


def _port_of(jax_net, tmp_path, name="lm.zip"):
    path = str(tmp_path / name)
    jser.write_model(jax_net, path)
    return tser.restore_model(path, device="cpu")


def _data(masked=False, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    fm = lm = None
    if masked:
        fm = np.ones((B, T), np.float32)
        fm[0, T // 2:] = 0               # tail padding
        fm[2, T - 3:] = 0
        lm = fm.copy()
        lm[1, :4] = 0                    # unscored leading steps
    return ids, y, fm, lm


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            jser._flatten_with_paths(tree).items()}


def _port_flat(tree):
    return tser._flatten(tree)


def _assert_trees(port, ref, atol, rtol):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    jn = _jax_lm()
    return jn, _port_of(jn, tmp_path_factory.mktemp("train"))


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("masked", [False, True])
def test_score_matches_jax(lm_pair, masked):
    jn, tn = lm_pair
    ids, y, fm, lm = _data(masked)
    ref = jn.score(JaxDataSet(ids, y, fm, lm))
    got = tn.score(DataSet(ids, y, fm, lm))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_by_param_path(lm_pair, masked):
    jn, tn = lm_pair
    ids, y, fm, lm = _data(masked, seed=1)
    batch = jn._batch_tuple(JaxDataSet(ids, y, fm, lm))
    (loss, _), grads = jax.value_and_grad(
        lambda p: jn._loss(p, jn.state, batch, None, training=True),
        has_aux=True)(jn.params)
    tloss, tgrads, _ = tn._gradients(
        tn._batch_tuple(DataSet(ids, y, fm, lm)))
    np.testing.assert_allclose(float(tloss), float(loss), atol=ATOL,
                               rtol=RTOL)
    _assert_trees(_port_flat(tgrads), _flat(grads), ATOL, RTOL)


# ------------------------------------------------------------ Adam steps

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_params_match_jax(tmp_path, steps, masked):
    jn = _jax_lm()
    tn = _port_of(jn, tmp_path)
    ids, y, fm, lm = _data(masked, seed=2)
    for _ in range(steps):
        jn.fit(JaxDataSet(ids, y, fm, lm))
        tn.fit(DataSet(ids, y, fm, lm))
    assert tn.iteration_count == jn.iteration_count == steps
    np.testing.assert_allclose(float(tn.score_value), float(jn.score_value),
                               atol=ATOL, rtol=RTOL)
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)
    _assert_trees(_port_flat(tn.opt_state), _flat(jn.opt_state), 1e-6,
                  1e-3)


def test_fit_over_arrays_and_iterators_matches_jax(tmp_path):
    """fit(features, labels, batch_size) batches like the JAX package's
    ArrayDataSetIterator (two batches: 3 + 1 rows)."""
    jn = _jax_lm()
    tn = _port_of(jn, tmp_path)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, V, (4, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (4, T))]
    jn.fit(ids, y, batch_size=3)
    tn.fit(ids, y, batch_size=3)
    assert tn.iteration_count == jn.iteration_count == 2
    assert tn.epoch_count == jn.epoch_count == 1
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)


@pytest.mark.parametrize("shuffle", [False, True])
def test_array_iterator_batches_match_jax(shuffle):
    x = np.arange(70, dtype=np.float32).reshape(10, 7)
    y = x * 2
    ref = JaxArrayIterator(x, y, 4, shuffle=shuffle, seed=5)
    got = ArrayDataSetIterator(x, y, 4, shuffle=shuffle, seed=5)
    for _ in range(2):                 # two epochs: new permutations
        a, b = list(ref), list(got)
        assert len(a) == len(b) == 3
        for r, g in zip(a, b):
            np.testing.assert_array_equal(g.features, r.features)
            np.testing.assert_array_equal(g.labels, r.labels)
    assert got.state_dict() == ref.state_dict()


def test_list_iterator_resumes_at_its_cursor():
    batches = [DataSet(np.full((2, 3), i, np.float32)) for i in range(4)]
    it = ListDataSetIterator(batches)
    seen = iter(it)
    next(seen), next(seen)
    state = it.state_dict()
    again = ListDataSetIterator(batches)
    again.load_state_dict(state)
    assert [int(b.features[0, 0]) for b in again] == [2, 3]
    with pytest.raises(ValueError, match="does not match"):
        ListDataSetIterator(batches[:2]).load_state_dict(state)


# ----------------------------------------------- dropout, regularization

def test_dropout_with_injected_mask_matches_jax(tmp_path, monkeypatch):
    jn = _jax_lm(out_kw={"dropout": 0.5})
    tn = _port_of(jn, tmp_path)
    keep = np.random.default_rng(4).random((B, T, D)) < 0.5
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep))
    monkeypatch.setattr(tbase, "dropout_keep_mask",
                        lambda shape, p, generator, device:
                        torch.from_numpy(keep))
    ids, y, _, _ = _data(seed=5)
    jn.fit(JaxDataSet(ids, y))
    tn.fit(DataSet(ids, y))
    np.testing.assert_allclose(float(tn.score_value), float(jn.score_value),
                               atol=ATOL, rtol=RTOL)
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)
    # no dropout outside training
    np.testing.assert_allclose(tn.score(DataSet(ids, y)),
                               jn.score(JaxDataSet(ids, y)), atol=ATOL,
                               rtol=RTOL)


def test_dropout_draws_from_the_generator_only_in_training():
    layer = tbase.BaseLayer(dropout=0.25)
    x = torch.ones(4, 1000)
    g = torch.Generator().manual_seed(0)
    assert layer.apply_input_dropout(x, training=False, generator=g) is x
    assert layer.apply_input_dropout(x, training=True, generator=None) is x
    out = layer.apply_input_dropout(x, training=True, generator=g)
    kept = out != 0
    assert 0.7 < kept.float().mean() < 0.8
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.75))


def test_l1_l2_terms_match_jax(tmp_path):
    jn = _jax_lm(out_kw={"l1": 1e-3, "l2": 1e-2, "l2_bias": 1e-2})
    tn = _port_of(jn, tmp_path)
    ids, y, _, _ = _data(seed=6)
    np.testing.assert_allclose(tn.score(DataSet(ids, y)),
                               jn.score(JaxDataSet(ids, y)), atol=ATOL,
                               rtol=RTOL)
    jreg = float(jn.layers[-1].regularization_loss(jn.params[-1]))
    treg = float(tn.layers[-1].regularization_loss(tn.params[-1]))
    np.testing.assert_allclose(treg, jreg, rtol=1e-5)
    jn.fit(JaxDataSet(ids, y))
    tn.fit(DataSet(ids, y))
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)


# ------------------------------------------------------------ update rules

_SCHED = {"exponential": {"type": "exponential", "gamma": 0.9},
          "inverse": {"type": "inverse", "gamma": 0.1, "power": 2.0},
          "poly": {"type": "poly", "power": 2.0, "max_iter": 2},
          "sigmoid": {"type": "sigmoid", "gamma": 0.5, "step": 1},
          "step": {"type": "step", "decay_rate": 0.5, "step": 2},
          "map": {"type": "map", "values": {"1": 0.05, "2": 0.01}},
          "warmup_cosine": {"type": "warmup_cosine", "warmup_steps": 1,
                            "total_steps": 4, "end_lr": 0.01}}

_RULES = {
    "sgd": jupd.sgd(0.1),
    "adam": jupd.adam(1e-2),
    "amsgrad": jupd.amsgrad(1e-2),
    "nadam": jupd.nadam(1e-2),
    "adamax": jupd.adamax(1e-2),
    "nesterovs": jupd.nesterovs(0.1, 0.8),
    "adagrad": jupd.adagrad(0.1),
    "adadelta": jupd.adadelta(0.9),
    "rmsprop": jupd.rmsprop(1e-2),
    "noop": jupd.noop(),
    **{f"sgd+{k}": jupd.sgd(0.1, schedule=s) for k, s in _SCHED.items()},
    "adam+step": jupd.adam(1e-2, schedule=_SCHED["step"]),
    "rmsprop+exponential": jupd.rmsprop(1e-2,
                                        schedule=_SCHED["exponential"]),
}


def _tree(rng, scale=1.0):
    return [{"W": (scale * rng.normal(size=(3, 4))).astype(np.float32),
             "b": (scale * rng.normal(size=(4,))).astype(np.float32)},
            {},
            {"attn": {"Wq": (scale * rng.normal(size=(4, 4)))
                      .astype(np.float32)},
             "g": (scale * rng.normal(size=(4,))).astype(np.float32)}]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.array(tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _run_both(jax_opt, port_opt, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jparams, tparams = params, _torch_tree(params)
    jstate, tstate = jax_opt.init(jparams), port_opt.init(tparams)
    _assert_trees(_port_flat(tstate), _flat(jstate), 0, 0)
    for _ in range(steps):
        g = _tree(rng, 0.5)
        ju, jstate = jax_opt.update(g, jstate, jparams)
        tu, tstate = port_opt.update(_torch_tree(g), tstate, tparams)
        _assert_trees(_port_flat(tu), _flat(ju), 1e-6, 1e-5)
        _assert_trees(_port_flat(tstate), _flat(jstate), 1e-6, 1e-5)
        jparams = optax.apply_updates(jparams, ju)
        tparams = tupd.apply_updates(tparams, tu)
    _assert_trees(_port_flat(tparams), _flat(jparams), 1e-6, 1e-5)


@pytest.mark.parametrize("name", sorted(_RULES))
def test_update_rule_matches_optax(name):
    cfg = _RULES[name]
    _run_both(jupd.to_optax(cfg), tupd.to_transform(cfg))


@pytest.mark.parametrize("clip", [{"type": "norm", "v": 0.5},
                                  {"type": "value", "v": 0.1}])
def test_overrides_and_gradient_clip_match_optax(clip):
    labels = ["layer0", "__global__", "__global__"]
    jlabels = [jax.tree_util.tree_map(lambda _: lab, t)
               for lab, t in zip(labels, _tree(np.random.default_rng(0)))]
    jax_opt = optax.multi_transform(
        {"__global__": jupd.to_optax(jupd.adam(1e-2)),
         "layer0": jupd.to_optax(jupd.sgd(0.1, _SCHED["exponential"]))},
        jlabels)
    port_opt = tupd.multi_transform(
        {"__global__": tupd.to_transform(tupd.adam(1e-2)),
         "layer0": tupd.to_transform(tupd.sgd(0.1, _SCHED["exponential"]))},
        labels)
    pre_j = (optax.clip_by_global_norm(clip["v"]) if clip["type"] == "norm"
             else optax.clip(clip["v"]))
    pre_t = (tupd.clip_by_global_norm(clip["v"]) if clip["type"] == "norm"
             else tupd.clip(clip["v"]))
    _run_both(optax.chain(pre_j, jax_opt), tupd.chain(pre_t, port_opt))


def test_network_overrides_and_clip_match_jax(tmp_path):
    """A per-layer updater override and gradient_clip on the LM: the
    same optimizer state keys as the JAX network, and the same params
    after two steps."""
    jn = _jax_lm(out_kw={"updater": jupd.sgd(0.05)}, clip=0.5)
    tn = _port_of(jn, tmp_path)
    keys = sorted(_port_flat(tn.opt_state))
    assert keys == sorted(_flat(jn.opt_state))
    # Adam's moments under the global label; layer 3's sgd keeps none
    assert "1/.inner_states/__global__/.inner_state/0/.mu/1/attn/Wq" in keys
    assert not any("/3/" in k for k in keys)
    ids, y, _, _ = _data(seed=7)
    for _ in range(2):
        jn.fit(JaxDataSet(ids, y))
        tn.fit(DataSet(ids, y))
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)
    _assert_trees(_port_flat(tn.opt_state), _flat(jn.opt_state), 1e-6,
                  1e-3)


def test_unknown_updater_and_schedule_raise():
    with pytest.raises(ValueError, match="updater type"):
        tupd.to_transform({"type": "lbfgs"})
    with pytest.raises(ValueError, match="schedule type"):
        tupd.make_schedule(0.1, {"type": "cyclic"})


# ------------------------------------------------- gradnorm, constraints

@pytest.mark.parametrize("kind", [
    "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
    "clip_element_wise_absolute_value", "clip_l2_per_layer",
    "clip_l2_per_param_type", "none"])
def test_gradient_normalization_matches_jax(kind):
    g = _tree(np.random.default_rng(8), 2.0)[0]
    ref = jgn.normalize_layer_gradients(g, kind, 0.7)
    got = tgn.normalize_layer_gradients(_torch_tree(g), kind, 0.7)
    _assert_trees(_port_flat(got), _flat(ref), 1e-6, 1e-5)


def test_gradient_normalization_per_layer_configs():
    class Cfg:
        gradient_normalization = "clip_l2_per_layer"
        gradient_normalization_threshold = 0.3
    grads = _tree(np.random.default_rng(9))
    layers = [Cfg(), object(), object()]
    ref = jgn.apply_gradient_normalization(layers, grads)
    got = tgn.apply_gradient_normalization(layers, _torch_tree(grads))
    _assert_trees(_port_flat(got), _flat(ref), 1e-6, 1e-5)
    with pytest.raises(ValueError, match="Unknown gradient"):
        tgn.normalize_layer_gradients({}, "bogus", 1.0)


@pytest.mark.parametrize("cfg", [
    {"type": "max_norm", "max_norm": 0.5},
    {"type": "min_max_norm", "min_norm": 0.2, "max_norm": 0.6,
     "rate": 0.7},
    {"type": "non_negative", "apply_to_biases": True},
    {"type": "unit_norm"}])
def test_constraints_match_jax(cfg):
    class Layer:
        constraints = (cfg,)
    p = _tree(np.random.default_rng(10))[0]
    ref = jcons.apply_layer_constraints(Layer(), p)
    got = tcons.apply_layer_constraints(Layer(), _torch_tree(p))
    _assert_trees(_port_flat(got), _flat(ref), 1e-6, 1e-5)


@pytest.mark.slow
def test_bench_leg_rate_diverges_at_full_width_in_both_packages(tmp_path):
    """Why chip_smoke.py trains the full-width LM at Adam 1e-4: at the
    transformer_lm bench leg's 1e-3, five steps on one repeated batch
    raise the loss, in the JAX package as in the port (width and depth
    of the leg, T and B cut for the CPU). The trajectories agree to
    rtol 2e-3: a diverging run amplifies last-bit differences."""
    Vf, Df, Lf, Hf, Tf, Bf = 2048, 1024, 8, 16, 64, 2
    b = (NeuralNetConfiguration.builder().set_seed(0)
         .updater(jupd.adam(1e-3)).list()
         .layer(EmbeddingSequenceLayer(n_in=Vf, n_out=Df)))
    for _ in range(Lf):
        b = b.layer(TransformerEncoderLayer(n_heads=Hf, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=Vf, loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(Vf, Tf)).build())
    jn = JaxNet(conf).init()
    tn = _port_of(jn, tmp_path)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, Vf, (Bf, Tf)).astype(np.float32)
    y = np.eye(Vf, dtype=np.float32)[rng.integers(0, Vf, (Bf, Tf))]
    jl, tl = [], []
    for _ in range(5):
        jn.fit(JaxDataSet(ids, y))
        tn.fit(DataSet(ids, y))
        jl.append(float(jn.score_value))
        tl.append(float(tn.score_value))
    print("adam 1e-3 losses, JAX package:", jl, "port:", tl)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert jl[-1] > jl[0] and tl[-1] > tl[0]


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_losses_match_jax(name):
    from deeplearning4j_tpu.nn import losses as jlosses
    rng = np.random.default_rng(11)
    labels = rng.random((3, 5, 4)).astype(np.float32)
    preds = rng.uniform(0.05, 0.95, (3, 5, 4)).astype(np.float32)
    mask = (rng.random((3, 5, 1)) > 0.3).astype(np.float32)
    for m in (None, mask):
        ref = jlosses.get(name)(labels, preds, m)
        got = tlosses.get(name)(*(None if a is None else torch.from_numpy(a)
                                  for a in (labels, preds, m)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act,loss", [("softmax", "mcxent"),
                                      ("sigmoid", "xent"),
                                      ("identity", "mse"),
                                      ("tanh", "l1")])
def test_output_layer_losses_match_jax(act, loss):
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOut
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        RnnOutputLayer as TorchRnnOut)
    rng = np.random.default_rng(12)
    params = {"W": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    tparams = _torch_tree(params)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    y = (rng.random((5, 4)) > 0.5).astype(np.float32)
    jl = JaxOut(n_in=6, n_out=4, activation=act, loss=loss)
    tl = OutputLayer(n_in=6, n_out=4, activation=act, loss=loss)
    ref = jl.loss_from_input(params, x, y, training=False, rng=None)
    got = tl.loss_from_input(tparams, torch.from_numpy(x),
                             torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-6,
                               rtol=1e-5)
    # the time-distributed head, masked mean over present steps
    x3 = rng.normal(size=(2, 7, 6)).astype(np.float32)
    y3 = (rng.random((2, 7, 4)) > 0.5).astype(np.float32)
    m = np.ones((2, 7), np.float32)
    m[1, 3:] = 0
    jr = RnnOutputLayer(n_in=6, n_out=4, activation=act, loss=loss)
    tr = TorchRnnOut(n_in=6, n_out=4, activation=act, loss=loss)
    for mask in (None, m):
        ref = jr.loss_from_input(params, x3, y3, training=False, rng=None,
                                 mask=mask)
        got = tr.loss_from_input(
            tparams, torch.from_numpy(x3), torch.from_numpy(y3),
            mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(ref), atol=1e-6,
                                   rtol=1e-5)


# ------------------------------------------------------------- checkpoints

def test_updater_state_keys_equal_jax(lm_pair, tmp_path):
    jn, tn = lm_pair
    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("updater_state.npz"))) as a:
            keys = set(a.files)
            assert a["0/.count"].dtype == np.int32
    assert keys == set(_flat(jn.opt_state))
    assert {"0/.count", "0/.mu/1/attn/Wq", "0/.nu/3/W"} <= keys
    jsched = _jax_lm(updater=jupd.adam(LR, schedule=_SCHED["step"]))
    tsched = _port_of(jsched, tmp_path, "sched.zip")
    assert set(_port_flat(tsched.opt_state)) == set(_flat(jsched.opt_state))
    assert "1/.count" in _port_flat(tsched.opt_state)


def test_jax_trained_zip_resumes_in_port(tmp_path):
    jn = _jax_lm()
    ids, y, _, _ = _data(seed=13)
    for _ in range(2):
        jn.fit(JaxDataSet(ids, y))
    path = str(tmp_path / "jax2.zip")
    jser.write_model(jn, path)
    tn = tser.restore_model(path, device="cpu")
    assert tn.iteration_count == 2
    assert int(tn.opt_state[0][".count"]) == 2
    jn.fit(JaxDataSet(ids, y))
    tn.fit(DataSet(ids, y))
    _assert_trees(_port_flat(tn.params), _flat(jn.params), P_ATOL, RTOL)


def test_port_trained_zip_resumes_in_jax(tmp_path):
    jn = _jax_lm()
    tn = _port_of(jn, tmp_path)
    ids, y, _, _ = _data(seed=14)
    for _ in range(2):
        tn.fit(DataSet(ids, y))
    path = str(tmp_path / "port2.zip")
    tser.write_model(tn, path)
    jr = jser.restore_model(path)
    assert jr.iteration_count == 2 and int(jr.opt_state[0].count) == 2
    jr.fit(JaxDataSet(ids, y))
    tn.fit(DataSet(ids, y))
    _assert_trees(_port_flat(tn.params), _flat(jr.params), P_ATOL, RTOL)


def test_changed_updater_keeps_fresh_state(tmp_path):
    jn = _jax_lm()
    ids, y, _, _ = _data()
    jn.fit(JaxDataSet(ids, y))
    path = str(tmp_path / "adam.zip")
    jser.write_model(jn, path)
    tn = tser.restore_model(path, device="cpu")
    # an adam zip restored with its own config keeps adam's state
    assert int(tn.opt_state[0][".count"]) == 1
    conf = tn.conf.to_dict()
    conf["global"]["updater"] = tupd.nesterovs(0.1)
    other = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                              device="cpu").init()
    other_path = str(tmp_path / "nesterovs.zip")
    tser.write_model(other, other_path)
    # a nesterovs state against an adam config does not fit: fresh state
    mixed = str(tmp_path / "mixed.zip")
    with zipfile.ZipFile(other_path) as z:
        opt = z.read("updater_state.npz")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(mixed, "w") as dst:
        for name in src.namelist():
            dst.writestr(name, opt if name == "updater_state.npz"
                         else src.read(name))
    restored = tser.restore_model(mixed, device="cpu")
    assert int(restored.opt_state[0][".count"]) == 0


# ------------------------------------------------------------- not ported

def test_unported_training_features_raise(lm_pair):
    _, tn = lm_pair
    ids, y, _, _ = _data()
    with pytest.raises(NotImplementedError, match="k-step"):
        tn.fit(DataSet(ids, y), steps_per_device_call=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        tn.fit(DataSet(ids, y), mesh_spec="dp=2")
    with pytest.raises(NotImplementedError, match="listeners"):
        tn.set_listeners(object())


def test_output_stays_inference_only(lm_pair):
    _, tn = lm_pair
    out = tn.output(_data()[0])
    assert out.grad_fn is None and not out.requires_grad
    assert all(p.requires_grad for p in tn.parameters())


def test_last_layer_without_loss_refuses_fit(tmp_path):
    conf = {"format_version": 1, "network_type": "MultiLayerNetwork",
            "global": {"seed": 0},
            "input_type": {"kind": "rnn", "size": V, "timesteps": T},
            "layers": [{"@type": "EmbeddingSequenceLayer", "n_in": V,
                        "n_out": D},
                       {"@type": "TransformerEncoderLayer", "n_heads": H}],
            "preprocessors": {}}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                            device="cpu").init()
    with pytest.raises(ValueError, match="no loss"):
        net.fit(DataSet(*_data()[:2]))
