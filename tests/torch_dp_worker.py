"""One rank of the port's data-parallel tests (not collected by pytest).

    DL4J_TPU_COORDINATOR=127.0.0.1:PORT DL4J_TPU_NUM_PROCESSES=N \\
    DL4J_TPU_PROCESS_ID=i python tests/torch_dp_worker.py DIR SCENARIO...

Each rank joins the gloo process group on the CPU, runs the named
scenarios on the inputs the test wrote into DIR (model zips written by
the JAX package, ``*.npz`` data) and writes ``DIR/SCENARIO_rank{i}.npz``.
The ``card`` scenario runs alone, on card 0: one rank joins over nccl,
two ranks over gloo.
The port only: this process imports nothing of JAX or the JAX package.
:func:`launch` starts the ranks and waits for them.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Ports for the rendezvous and the servers that tests start in
# subprocesses, handed out here and nowhere else. A port from bind(0) is
# free only until the socket closes: under the suite's parallel workers
# another test's bind(0), or any outgoing connection, can take it before
# the subprocess binds it. So ports come from below the kernel's
# ephemeral range, where neither reaches, in a block of this xdist
# worker's own (two workers of a run never hand out the same port). A
# process walks its block from an offset of its own pid, so two runs on
# one machine, whose workers share names and blocks, do not walk it in
# step; each port is checked free by a bind.
_PORT_BASE, _PORT_BLOCK, _PORT_BLOCKS = 16000, 1000, 16
_port_next = [os.getpid() % _PORT_BLOCK]


def free_port() -> int:
    """A localhost TCP port no other test of this run is handed."""
    name = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    idx = int(name[2:]) if name[2:].isdigit() else 0
    base = _PORT_BASE + (idx % _PORT_BLOCKS) * _PORT_BLOCK
    for _ in range(_PORT_BLOCK):
        port = base + _port_next[0] % _PORT_BLOCK
        _port_next[0] += 1
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {base}..{base + _PORT_BLOCK - 1}")


def launch(world, out_dir, scenarios, timeout=90, argv=None):
    """Run ``world`` ranks of this script (or of ``argv`` with the rank
    variables set) over ``out_dir``; returns their logs. Fails the
    caller's test, with every rank's log, on a non-zero exit or when the
    ranks together outlast ``timeout`` seconds; a failed rank stops the
    others, whose rendezvous would wait for it."""
    cmd = argv or [sys.executable, os.path.abspath(__file__),
                   str(out_dir)] + list(scenarios)
    port = free_port()
    procs, outs = [], []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   DL4J_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   DL4J_TPU_NUM_PROCESSES=str(world),
                   DL4J_TPU_PROCESS_ID=str(rank))
        out = tempfile.TemporaryFile()
        outs.append(out)
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(out_dir),
                                      stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
    logs = []
    for out in outs:
        out.seek(0)
        logs.append(out.read().decode(errors="replace"))
        out.close()
    everything = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{log}"
                           for r, (p, log) in enumerate(zip(procs, logs)))
    assert not timed_out, (f"the ranks outlasted {timeout} s; killed:\n"
                           + everything)
    assert all(p.returncode == 0 for p in procs), everything
    return logs


def load(out_dir, scenario, world):
    """Every rank's result of ``scenario``."""
    return [dict(np.load(os.path.join(str(out_dir),
                                      f"{scenario}_rank{r}.npz")))
            for r in range(world)]


# ---------------------------------------------------------------- ranks

def _net(name):
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    return restore_model(f"{name}.zip", device="cpu")


def _shard(a, rank, world):
    if a is None:
        return None
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


def _flat(net):
    return net.params_flat().astype(np.float32)


def _state_flat(net):
    from deeplearning4j_tpu_torch.util.tree import tree_flat_vector
    return np.asarray(tree_flat_vector(net.state), np.float32)


def sc_sgd(rank, world):
    """``fit(mesh_spec="dp=N")`` one step, then two more, on this
    rank's slice of the global batch."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.multihost import local_batch_slice
    d = np.load("sgd.npz")
    sl = local_batch_slice(d["x"].shape[0])
    ds = DataSet(d["x"][sl], d["y"][sl])
    net = _net("sgd")
    net.fit(ds, mesh_spec=f"dp={world}")
    p1 = _flat(net)
    net.fit(ds)
    net.fit(ds)
    return {"p1": p1, "p3": _flat(net),
            "loss": np.float32(net.score_value),
            "describe": np.array(json.dumps(net._mesh_ctx.describe(net)))}


def _batches(d, rank, world, n):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    return [DataSet(_shard(d[f"x{i}"], rank, world),
                    _shard(d[f"y{i}"], rank, world)) for i in range(n)]


def sc_graph(rank, world):
    """The graph executor: 6 batches in windows of 3, as
    ``tests/test_mesh_spec.py``'s dp=2 graph test."""
    d = np.load("graph.npz")
    net = _net("graph")
    net.fit(_batches(d, rank, world, 6), epochs=1, mesh_spec=f"dp={world}",
            steps_per_device_call=3)
    return {"p": _flat(net), "it": np.int64(net.iteration_count)}


def sc_kstep(rank, world):
    """11 batches, twice over: k=1 against k=8 (one window and a
    3-batch tail), both on the mesh."""
    d = np.load("sgd.npz")
    out = {}
    for k in (1, 8):
        net = _net("sgd")
        from deeplearning4j_tpu_torch.data.iterators import (
            ListDataSetIterator)
        net.fit(ListDataSetIterator(_batches(d, rank, world, 11)), epochs=2,
                mesh_spec=f"dp={world}", steps_per_device_call=k)
        out[f"k{k}"] = _flat(net)
        out[f"it{k}"] = np.int64(net.iteration_count)
    return out


def sc_uneven(rank, world):
    """Shards of unequal length (rank r holds 8 - r rows) and a step in
    which the last rank's shard is empty."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    d = np.load("sgd.npz")
    net = _net("sgd")
    x, y = d["x"][rank * 8:(rank + 1) * 8], d["y"][rank * 8:(rank + 1) * 8]
    n = 8 - rank
    batches = [DataSet(x[:n], y[:n])]
    last = 0 if rank == world - 1 else 4
    batches.append(DataSet(x[:last], y[:last]))
    net.use_mesh(f"dp={world}")
    for b in batches:
        net.fit(b)
    return {"p": _flat(net), "it": np.int64(net.iteration_count)}


def sc_rnn(rank, world):
    """A masked RnnOutputLayer net; the ranks' shards hold different
    numbers of present timesteps."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    d = np.load("rnn.npz")
    net = _net("rnn")
    ds = DataSet(_shard(d["x"], rank, world), _shard(d["y"], rank, world),
                 None, _shard(d["m"], rank, world))
    net.fit(ds, mesh_spec=f"dp={world}")
    loss1 = np.float32(net.score_value)
    net.fit(ds)
    return {"p": _flat(net), "loss1": loss1}


def _two_steps(name, rank, world):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    d = np.load(f"{name}.npz")
    net = _net(name)
    ds = DataSet(_shard(d["x"], rank, world), _shard(d["y"], rank, world))
    net.fit(ds, mesh_spec=f"dp={world}")
    net.fit(ds)
    return {"p": _flat(net), "state": _state_flat(net),
            "reduce": np.array(net._mesh_ctx.reduce_route(net))}


def sc_bn(rank, world):
    """A conv + batch-norm net: parameters and the running statistics
    after two steps over the global batch."""
    return _two_steps("bn", rank, world)


def sc_center(rank, world):
    """A center-loss head: parameters and the class centers after two
    steps over the global batch."""
    return _two_steps("center", rank, world)


def sc_compressed(rank, world):
    """ParallelWrapper with the int8 + EF reduce: 3 batches."""
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    d = np.load("sgd.npz")
    net = _net("sgd")
    pw = ParallelWrapper(net, build_mesh(MeshSpec(data=world)),
                         prefetch_buffer=0,
                         dcn_compression={"threshold": 0.0})
    assert not pw.supports_fused_windows()
    pw.fit(ListDataSetIterator(_batches(d, rank, world, 3)), epochs=1)
    res = np.concatenate([r.numpy().reshape(-1)
                          for r in tree_leaves(pw._residual)])
    return {"p": _flat(net), "residual": res,
            "loss": np.float32(net.score_value),
            "describe": np.array(json.dumps(pw.describe()))}


def sc_shrink(rank, world):
    """dp=4: a ``parallel.device`` loss at the second batch shrinks the
    mesh to dp=2 (ranks 0, 1); two batches there; a regrow over the
    four ranks; one batch on all four."""
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.observability.registry import REGISTRY
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    d = np.load("sgd.npz")
    batches = _batches(d, rank, world, 4)
    net = _net("sgd")
    pw = ParallelWrapper(net, build_mesh(MeshSpec(data=world)),
                         prefetch_buffer=0)
    chaos.install({"faults": [{"site": "parallel.device", "kind": "loss",
                               "at": [2]}]}, seed=7)
    trained = []
    try:
        for b in batches[:3]:
            trained.append(pw._train_batch(b))
        after_shrink = _flat(net)
        dp_shrunk = pw.mesh.size
        pw.regrow(range(world))
        trained.append(pw._train_batch(batches[3]))
    finally:
        chaos.uninstall()
    snap = REGISTRY.snapshot()
    return {"trained": np.array(trained), "after_shrink": after_shrink,
            "p": _flat(net), "dp_shrunk": np.int64(dp_shrunk),
            "dp_final": np.int64(pw.mesh.size),
            "shrinks": np.float64(snap.get("elastic_mesh_shrinks_total", 0)),
            "regrows": np.float64(snap.get("elastic_mesh_regrows_total", 0)),
            "it": np.int64(net.iteration_count)}


def sc_elastic(rank, world):
    """ElasticTrainer(mesh_spec="dp=N"): a run interrupted by a
    ``train.step`` crash at its 5th step and resumed by a new trainer,
    against an uninterrupted run; only the coordinator writes."""
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.train.fault_tolerance import ElasticTrainer
    d = np.load("sgd.npz")
    batches = _batches(d, rank, world, 8)

    def run(sub, crash):
        net = _net("sgd")
        tr = ElasticTrainer(net, sub, save_every=2, handle_sigterm=False,
                            mesh_spec=f"dp={world}")
        if crash:
            chaos.install({"faults": [{"site": "train.step",
                                       "kind": "crash", "at": [5]}]},
                          seed=1)
            try:
                tr.fit(ListDataSetIterator(batches), epochs=1)
                raise AssertionError("the crash did not fire")
            except chaos.SimulatedCrashError:
                pass
            finally:
                chaos.uninstall()
            net = _net("sgd")
            tr = ElasticTrainer(net, sub, save_every=2,
                                handle_sigterm=False,
                                mesh_spec=f"dp={world}")
        tr.fit(ListDataSetIterator(batches), epochs=1)
        return net

    free = run("free", False)
    resumed = run("crashed", True)
    return {"free": _flat(free), "resumed": _flat(resumed),
            "it": np.int64(resumed.iteration_count),
            "zips": np.int64(len([f for f in os.listdir("free")
                                  if f.endswith(".zip")]))}


def sc_elastic_wrapper(rank, world):
    """ElasticTrainer(wrapper=ParallelWrapper): k=4 windows through
    ``wrapper.fit_batches`` against k=1 batches through
    ``wrapper.fit_batch``."""
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.train.fault_tolerance import ElasticTrainer
    d = np.load("sgd.npz")
    out = {}
    for k in (1, 4):
        net = _net("sgd")
        pw = ParallelWrapper(net, build_mesh(MeshSpec(data=world)),
                             prefetch_buffer=0)
        ElasticTrainer(net, f"wrapper_k{k}", save_every=4,
                       handle_sigterm=False, wrapper=pw,
                       steps_per_device_call=k).fit(
            ListDataSetIterator(_batches(d, rank, world, 8)), epochs=1)
        out[f"k{k}"] = _flat(net)
        out[f"it{k}"] = np.int64(net.iteration_count)
    return out


def sc_respec(rank, world):
    """The same spec again: ``build_mesh_context`` over a subset of the
    group makes its groups once (``dist.new_group`` counted), and a
    member's ``fit(mesh_spec=)`` with an unchanged spec keeps the
    installed context, with no collective."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    made = []
    real = dist.new_group

    def counted(*a, **k):
        made.append(a)
        return real(*a, **k)

    dist.new_group = counted
    try:
        first = build_mesh_context("dp=2")
        after_first = len(made)
        again = build_mesh_context("dp=2")
        same_groups = again.group is first.group
        kept = True
        if first.member:
            d = np.load("sgd.npz")
            net = _net("sgd")
            ds = DataSet(_shard(d["x0"], rank, 2), _shard(d["y0"], rank, 2))
            net.fit(ds, mesh_spec="dp=2")
            ctx = net._mesh_ctx
            for _ in range(3):
                net.fit(ds, mesh_spec="dp=2")
                kept &= net._mesh_ctx is ctx
    finally:
        dist.new_group = real
    return {"after_first": np.int64(after_first),
            "total": np.int64(len(made)), "same_groups": same_groups,
            "kept": kept}


# ---- on the card (``cuda``-marked tests): the captured and eager routes

def _card_net():
    """8 -> 32 tanh -> 3, Adam 1e-2, on the card."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": 4, "updater": updaters.adam(1e-2)},
           "input_type": {"kind": "ff", "size": 8},
           "layers": [{"@type": "DenseLayer", "n_out": 32,
                       "activation": "tanh"},
                      {"@type": "OutputLayer", "n_out": 3}],
           "preprocessors": {}}
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device="cuda:0").init()


def _all_leaves(net):
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    leaves = {"p/" + k: v for k, v in _flatten(net.params).items()}
    leaves.update({"o/" + k: v for k, v in _flatten(net.opt_state).items()})
    return np.concatenate([np.asarray(leaves[k], np.float64).ravel()
                           for k in sorted(leaves)])


def sc_card(rank, world):
    """16 batches of 16 global rows through ``fit`` on the mesh at k=1
    and at k=8 (under nccl: the first step or window eager plus the
    capture, the rest replays), and the eager data-parallel step
    (``_train_step`` in the step's scope) on the same shards; under
    cuBLAS's and cuDNN's deterministic algorithms."""
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.observability import compile_watch
    from deeplearning4j_tpu_torch.parallel import global_batch
    from deeplearning4j_tpu_torch.parallel.multihost import local_batch_slice
    torch.use_deterministic_algorithms(True)
    stats = compile_watch.install_global_watch()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 16, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (16, 16))]
    sl = local_batch_slice(16)
    batches = [DataSet(x[i][sl], y[i][sl]) for i in range(16)]
    out = {}
    for k in (1, 8):
        net = _card_net()
        net.use_mesh(f"dp={world}")
        mark = stats.mark()
        net.fit(ListDataSetIterator(batches), steps_per_device_call=k)
        torch.cuda.synchronize()
        s = stats.summary(mark)
        out[f"captures_k{k}"] = np.int64(s["graph_captures"])
        out[f"replays_k{k}"] = np.int64(s["graph_replays"])
        out[f"fit_k{k}"] = _all_leaves(net)
        out[f"it_k{k}"] = np.int64(net.iteration_count)
    ref = _card_net()
    ref.use_mesh(f"dp={world}")
    for ds in batches:
        with global_batch.scope(ref._mesh_ctx):
            ref._train_step(ref._batch_tuple(ref._coerce_fit_batch(ds)))
    torch.cuda.synchronize()
    out["eager"] = _all_leaves(ref)
    out["route"] = np.array(net._mesh_ctx.reduce_route(net))
    out["backend"] = np.array(net._mesh_ctx.backend)
    return out


def sc_word2vec(rank, world):
    """``Word2Vec.fit(mesh=)`` over the data axis of every rank, on the
    corpus and configuration in ``word2vec.json``."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    with open("word2vec.json") as f:
        cfg = json.load(f)
    w = (Word2Vec.builder().iterate(cfg["corpus"])
         .layer_size(cfg["layer_size"]).min_word_frequency(1)
         .epochs(cfg["epochs"]).batch_size(cfg["batch_size"])
         .seed(cfg["seed"]).use_hierarchic_softmax(cfg["hs"])
         .device("cpu").build())
    w.fit(mesh=build_mesh(MeshSpec(data=world)))
    return {"syn0": w.syn0, "syn1": w.syn1,
            "nearest": np.array(json.dumps(w.words_nearest(
                cfg["query"], n=3)))}


def estimator_conf():
    """tests/test_ui_services.py's estimator network, built by the
    port's own builder."""
    from deeplearning4j_tpu_torch.nn.conf import layers, updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    return (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updaters.adam(0.05)).list()
            .layer(layers.DenseLayer(n_out=12, activation="relu"))
            .layer(layers.OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())


def sc_estimator(rank, world):
    """``NetworkEstimator(mesh=)``: every rank fits on the same full
    arrays of ``estimator.npz`` (40-row global batches, 60 epochs)."""
    from deeplearning4j_tpu_torch.ml import NetworkEstimator
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    d = np.load("estimator.npz")
    model = NetworkEstimator(estimator_conf, epochs=60, batch_size=40,
                             mesh=build_mesh(MeshSpec(data=world)),
                             device="cpu").fit(d["x"], d["y"])
    return {"flat": _flat(model.network), "probs": model.transform(d["xt"])}


def sc_long_context(rank, world):
    """The long-context example's training at data=2 x seq=2 from
    long_context.zip (the JAX example's ``make_net(seed=3)``) on the
    port example's data, for long_context.npz's epochs: the final
    parameters and loss."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.examples.long_context_lm import make_data
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    epochs = int(np.load("long_context.npz")["epochs"])
    x, y, mask = make_data()
    net = _net("long_context")
    pw = ParallelWrapper(net, build_mesh(MeshSpec(data=2, seq=2)),
                         prefetch_buffer=0)
    loc = pw.local_shard
    ds = DataSet(loc(x), loc(y), loc(mask), loc(mask))
    pw.fit(ListDataSetIterator([ds]), epochs=epochs)
    return {"flat": _flat(net), "loss": np.float32(net.score_value)}


SCENARIOS = {n[3:]: f for n, f in list(globals().items())
             if n.startswith("sc_")}


def process_count_env():
    return int(os.environ.get("DL4J_TPU_NUM_PROCESSES", "1"))


def main():
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, process_count, process_index)
    out_dir, names = sys.argv[1], sys.argv[2:]
    os.chdir(out_dir)
    # the card scenario's ranks share card 0 (gloo when there are two)
    card = names == ["card"]
    if card:        # cuBLAS's deterministic mode, before its first handle
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    assert initialize_distributed(
        device="cuda:0" if card else "cpu",
        backend="gloo" if card and process_count_env() > 1 else None)
    rank, world = process_index(), process_count()
    for name in names:
        res = SCENARIOS[name](rank, world)
        np.savez(f"{name}_rank{rank}.npz", **res)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
