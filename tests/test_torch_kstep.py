"""The port's training programs, k-step windows and AOT training warmup
against the JAX package, on the CPU (and, marked ``cuda``, the captured
graph against the eager step on a card).

A JAX network is written to a zip and restored in the port, so both
start from the same weights; the same seeded numpy batches then go
through ``fit_batches`` / ``fit(steps_per_device_call=k)`` in both.
Losses, the ``[k, 5]`` health block and the params are held at float32
tolerance (atol 1e-5, rtol 1e-4: the same Adam steps with sums in
another order); batch-norm's running statistics ride in the state and
are held the same way. Dropout is off (the packages draw different
bits).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import (
    ListDataSetIterator as JListIt)
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
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ListDataSetIterator as TListIt)
from deeplearning4j_tpu_torch.models import kstep
from deeplearning4j_tpu_torch.util import model_serializer as tser

ATOL, RTOL = 1e-5, 1e-4
EXECUTORS = ["mln", "graph"]


def _mln_conf(tbptt=None):
    b = JaxBuilder.builder().set_seed(3).updater(jupd.adam(0.01))
    if tbptt:
        b = b.backprop_type("tbptt", fwd_length=tbptt)
        return (b.list().layer(jl.LSTM(n_out=5))
                .layer(jl.RnnOutputLayer(n_out=3, activation="softmax"))
                .set_input_type(JIT.recurrent(2, 7)).build())
    return (b.list().layer(jl.DenseLayer(n_out=8, activation="tanh"))
            .layer(jl.BatchNormalization())
            .layer(jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.feed_forward(4)).build())


def _graph_conf(tbptt=None):
    b = JaxBuilder.builder().set_seed(4).updater(jupd.adam(0.01))
    if tbptt:
        b = b.backprop_type("tbptt", fwd_length=tbptt)
    g = b.graph_builder().add_inputs("in")
    if tbptt:
        g.set_input_types(JIT.recurrent(2, 7))
        g.add_layer("r", jl.LSTM(n_out=5), "in")
        g.add_layer("out", jl.RnnOutputLayer(n_out=3,
                                             activation="softmax"), "r")
    else:
        g.set_input_types(JIT.feed_forward(4))
        g.add_layer("d", jl.DenseLayer(n_out=8, activation="tanh"), "in")
        g.add_layer("bn", jl.BatchNormalization(), "d")
        g.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax"),
                    "bn")
    return g.set_outputs("out").build()


def _pair(tmp_path, executor, tbptt=None):
    jn = (JGraph(_graph_conf(tbptt)) if executor == "graph"
          else JNet(_mln_conf(tbptt))).init()
    path = str(tmp_path / f"{executor}.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def _batches(n, seed, b=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, 3, b)
        x = (rng.normal(size=(b, 4)) + y[:, None]).astype(np.float32)
        out.append((x, np.eye(3, dtype=np.float32)[y]))
    return out


def _seq_batches(n, seed, b=3, t=7):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, t, 2)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t))])
            for _ in range(n)]


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            jser._flatten_with_paths(tree).items()}


def _assert_trees(port, jax_tree):
    got, want = tser._flatten(port), _flat(jax_tree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def _assert_model(tn, jn):
    _assert_trees(tn.params, jn.params)
    _assert_trees(tn.state, jn.state)
    _assert_trees(tn.opt_state, jn.opt_state)
    assert tn.iteration_count == jn.iteration_count


class _HealthRows:
    """Records every step's fused health row (one class a package, each
    asking its executor for device health)."""

    wants_device_health = True

    def __init__(self):
        self.rows, self.losses = [], []

    def iteration_done(self, model, iteration, score, batch_size):
        vec = model._last_health
        if isinstance(vec, torch.Tensor):
            vec = vec.cpu().numpy()
        self.rows.append(np.asarray(vec, dtype=np.float64))
        self.losses.append(float(score))

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


@pytest.mark.parametrize("executor", EXECUTORS)
def test_fit_batches_window_matches_jax(tmp_path, executor):
    """One window of 8 as one k-step program: the 8 per-step losses,
    the [8, 5] health block, the params, batch-norm state and Adam
    state after it equal the JAX package's fused scan."""
    jn, tn = _pair(tmp_path, executor)
    jrec, trec = _HealthRows(), _HealthRows()
    jn.set_listeners(jrec)
    tn.set_listeners(trec)
    data = _batches(8, seed=1)
    jl_ = jn.fit_batches([JDataSet(x, y) for x, y in data],
                         steps_per_device_call=8)
    tl_ = tn.fit_batches([TDataSet(x, y) for x, y in data],
                         steps_per_device_call=8)
    assert tl_.shape == (8,) and tl_.dtype == jl_.dtype
    np.testing.assert_allclose(tl_, jl_, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.stack(trec.rows), np.stack(jrec.rows),
                               atol=ATOL, rtol=RTOL)
    assert np.stack(trec.rows).shape == (8, 5)
    assert {key[:3] for key in tn._programs} == {(8, False, True)}
    _assert_model(tn, jn)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_fit_eleven_batches_runs_8_then_3(tmp_path, executor, monkeypatch):
    """``fit(steps_per_device_call=8)`` over 11 batches for 2 epochs: a
    window of 8 through the k-step program and the 3-batch tail through
    the k=1 program each epoch; params equal JAX's."""
    jn, tn = _pair(tmp_path, executor)
    data = _batches(11, seed=2)
    calls = []
    run = kstep.TrainProgram.run

    def spy(self, window, carries=None):
        calls.append(self.k)
        return run(self, window, carries)
    monkeypatch.setattr(kstep.TrainProgram, "run", spy)
    jn.fit(JListIt([JDataSet(x, y) for x, y in data]), epochs=2,
           steps_per_device_call=8)
    tn.fit(TListIt([TDataSet(x, y) for x, y in data]), epochs=2,
           steps_per_device_call=8)
    assert calls == [8, 1, 1, 1] * 2
    assert tn.epoch_count == jn.epoch_count == 2
    _assert_model(tn, jn)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_k8_equals_k1_in_the_port(tmp_path, executor):
    """The k-step body is the single step's: the same 11 batches at k=8
    and k=1 give the same params bit for bit."""
    _, a = _pair(tmp_path, executor)
    b = tser.restore_model(str(tmp_path / f"{executor}.zip"), device="cpu")
    data = [TDataSet(x, y) for x, y in _batches(11, seed=5)]
    a.fit(TListIt(list(data)), steps_per_device_call=8)
    b.fit(TListIt(list(data)), steps_per_device_call=1)
    for k, v in tser._flatten(a.params).items():
        np.testing.assert_array_equal(v, tser._flatten(b.params)[k])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_tbptt_entries_flush_the_window(tmp_path, executor):
    """tBPTT (T=7 in chunks of 3: 3 chunk steps a batch) under
    ``steps_per_device_call=4``: each sequence batch runs its chunks in
    order through the chunk program; losses of every chunk and the
    params equal the JAX package's."""
    jn, tn = _pair(tmp_path, executor, tbptt=3)
    jrec, trec = _HealthRows(), _HealthRows()
    jrec.wants_device_health = trec.wants_device_health = False
    jn.set_listeners(jrec)
    tn.set_listeners(trec)
    data = _seq_batches(5, seed=3)
    jn.fit(JListIt([JDataSet(x, y) for x, y in data]),
           steps_per_device_call=4)
    tn.fit(TListIt([TDataSet(x, y) for x, y in data]),
           steps_per_device_call=4)
    assert tn.iteration_count == jn.iteration_count == 15
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=ATOL,
                               rtol=RTOL)
    assert {key[1] for key in tn._programs} == {True}
    _assert_model(tn, jn)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_warmup_leaves_the_model_unchanged(tmp_path, executor):
    """``warmup`` builds the k=1 and the k-step program (the keys of
    JAX's report), runs each once and undoes it: params, state, Adam
    state, counters and the dropout generator are as before, and a fit
    after it equals a fit without it. A second warmup builds nothing."""
    jn, tn = _pair(tmp_path, executor)
    _, ref = _pair(tmp_path, executor)
    x, y = _batches(1, seed=4)[0]
    tn.fit_batches([])          # makes the optimizer and the generator
    before = {n: tser._flatten(getattr(tn, n))
              for n in ("params", "state", "opt_state")}
    gen = tn._generator.get_state()
    jrep = jn.warmup(JDataSet(x, y), steps_per_device_call=4)
    trep = tn.warmup(TDataSet(x, y), steps_per_device_call=4)
    assert set(trep) == set(jrep) == {"train_step", "kstep_4"}
    assert all(v >= 0 for v in trep.values())
    for n, flat in before.items():
        for k, v in tser._flatten(getattr(tn, n)).items():
            np.testing.assert_array_equal(v, flat[k], err_msg=f"{n}/{k}")
    assert torch.equal(tn._generator.get_state(), gen)
    assert tn.iteration_count == 0
    assert tn.warmup(TDataSet(x, y), steps_per_device_call=4) == {}
    warmed = set(tn._programs)
    data = [TDataSet(a, b) for a, b in _batches(8, seed=6)]
    tn.fit(TListIt(list(data)), steps_per_device_call=4)
    tn.fit(TListIt(data[:1]))
    assert set(tn._programs) == warmed      # fit built nothing new
    ref.fit(TListIt(list(data)), steps_per_device_call=4)
    ref.fit(TListIt(data[:1]))
    for k, v in tser._flatten(tn.params).items():
        np.testing.assert_array_equal(v, tser._flatten(ref.params)[k])


def test_window_of_mixed_shapes_runs_step_by_step(tmp_path):
    """A window whose batches differ in shape does not fuse: each runs
    through the k=1 program of its own signature, as in JAX."""
    jn, tn = _pair(tmp_path, "mln")
    a, b = _batches(2, seed=7), _batches(2, seed=8, b=5)
    mixed = [a[0], b[0], a[1], b[1]]
    jl_ = jn.fit_batches([JDataSet(x, y) for x, y in mixed],
                         steps_per_device_call=4)
    tl_ = tn.fit_batches([TDataSet(x, y) for x, y in mixed],
                         steps_per_device_call=4)
    np.testing.assert_allclose(tl_, jl_, atol=ATOL, rtol=RTOL)
    assert sorted(key[0] for key in tn._programs) == [1, 1]
    _assert_model(tn, jn)


def test_health_toggle_and_rebinding_drop_the_programs(tmp_path):
    """A health listener attached or removed, a new optimizer, rebound
    params or state: every program is dropped (the graphs baked the old
    addresses and outputs)."""
    _, tn = _pair(tmp_path, "mln")
    x, y = _batches(1, seed=9)[0]
    tn.fit(TDataSet(x, y))
    assert len(tn._programs) == 1
    tn.set_listeners(_HealthRows())
    tn.fit(TDataSet(x, y))
    assert [key[2] for key in tn._programs] == [True]
    for rebind in (lambda: tn._build_optimizer(),
                   lambda: tn.set_params(tn.params),
                   lambda: setattr(tn, "state", tn.state)):
        tn.fit(TDataSet(x, y))
        assert tn._programs
        rebind()
        assert not tn._programs
    tn.set_listeners()
    tn.fit(TDataSet(x, y))
    tn.set_listeners(_HealthRows())
    tn.fit_batches([TDataSet(x, y)])
    assert [key[2] for key in tn._programs] == [True]


def test_a_tree_given_to_the_model_is_copied(tmp_path):
    """A step updates the layer state and the updater state in place;
    a tree the caller assigned stays as it was (as JAX's immutable
    arrays do)."""
    _, tn = _pair(tmp_path, "mln")
    given = tser._flatten(tn.state)
    mine = [{k: v.clone() for k, v in s.items()} for s in tn.state]
    tn.state = mine
    x, y = _batches(1, seed=13)[0]
    tn.fit(TDataSet(x, y))
    for k, v in tser._flatten(mine).items():
        np.testing.assert_array_equal(v, given[k])
    assert any(not np.array_equal(v, given[k])
               for k, v in tser._flatten(tn.state).items())


def test_invalid_k_and_mesh(tmp_path):
    _, tn = _pair(tmp_path, "mln")
    x, y = _batches(1, seed=10)[0]
    with pytest.raises(ValueError, match="steps_per_device_call"):
        tn.fit_batches([TDataSet(x, y)], steps_per_device_call=0)
    # data parallelism is ported (tests/test_torch_parallel.py): one
    # process is one rank, and tensor parallelism waits for A6b
    with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR"):
        tn.warmup(TDataSet(x, y), mesh_spec="dp=2")
    with pytest.raises(NotImplementedError, match="A6b"):
        tn.warmup(TDataSet(x, y), mesh_spec="tp=2")


def test_feed_forward_and_clone_match_jax(tmp_path):
    """``feed_forward`` gives every layer's activation, as JAX's; a
    clone holds copies (training it leaves the original alone)."""
    jn, tn = _pair(tmp_path, "mln")
    x, y = _batches(1, seed=11)[0]
    ja, ta = jn.feed_forward(x), tn.feed_forward(x)
    assert len(ta) == len(ja) == 3
    for t, j in zip(ta, ja):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=RTOL)
    c = tn.clone()
    before = tser._flatten(tn.params)
    for k, v in tser._flatten(c.params).items():
        np.testing.assert_array_equal(v, before[k])
    c.fit(TDataSet(x, y))
    for k, v in tser._flatten(tn.params).items():
        np.testing.assert_array_equal(v, before[k])


def test_signature_and_stacking():
    a = kstep.host_batch((np.zeros((2, 3)), None, np.ones((2,), np.int64)))
    assert a[0].dtype == torch.float32 and a[1] is None
    assert kstep.signature(a) == (((2, 3), "torch.float32"), None,
                                  ((2,), "torch.int64"))
    w = kstep.stack_batches([a, a, a])
    assert tuple(w[0].shape) == (3, 2, 3) and w[1] is None
    with pytest.raises(ValueError, match="at least 2"):
        kstep.stack_batches([a])


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_pair(tmp_path, executor):
    jn = (JGraph(_graph_conf()) if executor == "graph"
          else JNet(_mln_conf())).init()
    path = str(tmp_path / f"{executor}.zip")
    jser.write_model(jn, path)
    return (tser.restore_model(path, device="cuda"),
            tser.restore_model(path, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("executor", EXECUTORS)
def test_captured_step_equals_eager_on_card(tmp_path, executor,
                                            cuda_device):
    """5 steps through the captured graph (one capture, 4 replays)
    against 5 eager ``_train_step`` calls on the card: losses and every
    param, state and updater leaf within f32 tolerance (the same
    kernels; cuBLAS may pick another split-K for the two streams)."""
    from deeplearning4j_tpu_torch.observability import compile_watch
    stats = compile_watch.install_global_watch()
    captured, eager = _card_pair(tmp_path, executor)
    data = _batches(5, seed=12)
    mark = stats.mark()
    losses = []
    for x, y in data:
        captured.fit(TDataSet(x, y))
        losses.append(float(captured.score_value))
    s = stats.summary(mark)
    assert s["graph_captures"] == 1 and s["graph_replays"] == 4
    ref = []
    for x, y in data:
        batch = eager._batch_tuple(eager._coerce_fit_batch(TDataSet(x, y)))
        ref.append(float(eager._train_step(batch)[0]))
    np.testing.assert_allclose(losses, ref, atol=ATOL, rtol=RTOL)
    for name in ("params", "state", "opt_state"):
        got = tser._flatten(getattr(captured, name))
        for k, v in tser._flatten(getattr(eager, name)).items():
            np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name}/{k}")


@pytest.mark.cuda
def test_attention_kernels_count_per_replay(tmp_path, cuda_device):
    """An LM with head dim 32 (the kernels' smallest): 3 captured steps
    of 2 transformer layers launch the forward, dq and dk/dv kernels 2
    times a step each, counted on every replay (and the backward's,
    which runs on autograd's device thread)."""
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.ops import attention as att
    V, T = 64, 32
    conf = {"format_version": 1, "network_type": "MultiLayerNetwork",
            "global": {"seed": 0, "updater": {"type": "adam", "lr": 1e-3}},
            "input_type": {"kind": "rnn", "size": V, "timesteps": T},
            "layers": [{"@type": "EmbeddingSequenceLayer", "n_in": V,
                        "n_out": 128}]
            + [{"@type": "TransformerEncoderLayer", "n_heads": 4,
                "causal": True}] * 2
            + [{"@type": "RnnOutputLayer", "n_out": V, "loss": "mcxent"}],
            "preprocessors": {}}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                            device="cuda").init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (2, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (2, T))]
    wrappers = (att.flash_attention_fwd_cuda, att.flash_attention_bwd_dq_cuda,
                att.flash_attention_bwd_dkv_cuda)
    for w in wrappers:
        w.launches = 0
    for _ in range(3):
        net.fit(TDataSet(ids, y))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [6, 6, 6]
    prog = next(iter(net._programs.values()))
    assert prog.replays == 2
    assert {w: prog.tally[w] for w in wrappers} == dict.fromkeys(wrappers, 2)
