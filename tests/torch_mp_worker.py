"""One rank of the port's tensor-, sequence- and pipeline-parallel tests
(not collected by pytest).

    DL4J_TPU_COORDINATOR=127.0.0.1:PORT DL4J_TPU_NUM_PROCESSES=N \\
    DL4J_TPU_PROCESS_ID=i python tests/torch_mp_worker.py DIR SCENARIO...

Each rank joins the gloo process group on the CPU, runs the named
scenarios on the inputs the test wrote into DIR (model zips written by
the JAX package, ``*.npz`` data) and writes ``DIR/SCENARIO_rank{i}.npz``.
A scenario name may carry its mesh after a colon (``sp:dp=2,seq=2``).
The ``card`` scenario runs on card 0 (two ranks over gloo).
The port only: this process imports nothing of JAX or the JAX package.
Tests start the ranks with ``torch_dp_worker.launch(..., argv=)``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_dp_worker import _flat, _net  # noqa: E402


def _mesh(spec):
    """A port mesh from 'data=2,seq=2' (every rank calls it)."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    kw = {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}
    return build_mesh(MeshSpec(**kw))


def sc_ring(rank, world, arg):
    """``ring_self_attention`` at sp = world on this rank's chunk of
    ring.npz's q, k, v: the output (padded query rows zeroed when
    masked, as the layer does) and the q/k/v gradients of
    sum(out * do), causal and not, masked and not."""
    import torch
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        make_ring_attention_fn, ring_self_attention)
    d = np.load("ring.npz")
    ctx = build_mesh_context(f"sp={world}", allow_sp=True)
    grp = ctx.seq_group()
    out = {}
    loc = lambda a: torch.from_numpy(ctx.local_shard(a))
    for causal in (False, True):
        for masked in (False, True):
            tag = f"c{int(causal)}m{int(masked)}"
            q, k, v = (loc(d[n]).requires_grad_(True) for n in "qkv")
            o = ring_self_attention(q, k, v, group=grp, causal=causal,
                                    kv_mask=loc(d["mask"]) if masked
                                    else None)
            if masked:          # padded query rows zeroed, as the layer
                o = o * loc(d["mask"])[:, :, None, None]
            (o * loc(d["do"])).sum().backward()
            out[tag] = o.detach().numpy()
            for n, t in zip("qkv", (q, k, v)):
                out[f"{tag}_d{n}"] = t.grad.numpy()
    fn = make_ring_attention_fn(ctx, causal=True)
    out["fn"] = fn(*(loc(d[n]) for n in "qkv")).numpy()
    return out


def _fit_steps(net, ds, steps, mesh_spec=None):
    for i in range(steps):
        net.fit(ds, mesh_spec=mesh_spec if i == 0 else None)
    return net


def sc_tp(rank, world, arg):
    """``fit(mesh_spec=arg)`` (dp x tp) of the zips named in tp.json,
    each for its step count, on this rank's rows."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    with open("tp.json") as f:
        jobs = json.load(f)
    ctx = build_mesh_context(arg)
    out = {}
    for name, steps in jobs:
        d = np.load(f"{name}.npz")
        net = _net(name)
        ds = DataSet(*(ctx.local_shard(d[k], temporal=False)
                       for k in ("x", "y")))
        _fit_steps(net, ds, steps, mesh_spec=ctx)
        out[name] = _flat(net)
        out[name + "_modes"] = np.array(json.dumps(net._tp.describe()))
        if name == "lm":
            from deeplearning4j_tpu_torch.util.model_serializer import (
                snapshot_model, write_snapshot)
            snap = snapshot_model(net)
            if rank == 0:
                write_snapshot(snap, "lm_tp.zip")
    return out


def _health_rows():
    """A listener that asks for the fused health vector and keeps each
    step's row (``.rows``)."""
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    class HealthRows(TrainingListener):
        wants_device_health = True

        def __init__(self):
            self.rows = []

        def iteration_done(self, model, iteration, score, batch_size):
            self.rows.append(np.asarray(model._last_health, np.float32))
    return HealthRows()


def sc_tph(rank, world, arg):
    """health.zip's model for health.json's step count under ``arg``
    (dp x tp), with a StatsListener reporting every step on every rank
    and a health-vector listener, both on every rank (each is
    collective over the model group): the health rows, and each
    report's parameter and update magnitudes."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    from deeplearning4j_tpu_torch.ui.stats import (InMemoryStatsStorage,
                                                   StatsListener)
    with open("health.json") as f:
        steps = json.load(f)
    ctx = build_mesh_context(arg)
    d = np.load("health.npz")
    net = _net("health")
    rows, storage = _health_rows(), InMemoryStatsStorage()
    stats = StatsListener(storage, frequency=1, session_id="s",
                          collect_histograms=False)
    net.set_listeners(rows, stats)
    ds = DataSet(*(ctx.local_shard(d[k], temporal=False) for k in ("x", "y")))
    _fit_steps(net, ds, steps, mesh_spec=ctx)
    reports = [{"param": r.param_mean_magnitudes,
                "update": r.update_mean_magnitudes}
               for r in storage.get_all_updates("s")]
    return {"rows": np.stack(rows.rows),
            "reports": np.array(json.dumps(reports)),
            "p": _flat(net)}


def sc_tpk(rank, world, arg):
    """k-step windows under ``arg`` (dp x tp): 4 batches of mlp.npz's
    rows through ``fit`` at k=1, and after ``warmup(mesh_spec=)`` at
    k=2 (one window of two programs' steps)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    d = np.load("mlp.npz")
    ctx = build_mesh_context(arg)
    batches = [DataSet(ctx.local_shard(d["x"][i:i + 16], temporal=False),
                       ctx.local_shard(d["y"][i:i + 16], temporal=False))
               for i in range(0, 64, 16)]
    out = {}
    for k in (1, 2):
        net = _net("mlp")
        if k > 1:
            p0 = net.params_flat()
            warm = net.warmup(batches[0], steps_per_device_call=k,
                              mesh_spec=ctx)
            out["warm_keys"] = np.array(sorted(warm))
            out["warm_unchanged"] = np.array_equal(net.params_flat(), p0)
        net.fit(ListDataSetIterator(batches), mesh_spec=ctx,
                steps_per_device_call=k)
        out[f"k{k}"] = _flat(net)
        out[f"it{k}"] = np.int64(net.iteration_count)
    return out


def sc_sp(rank, world, arg):
    """``ParallelWrapper`` over the mesh ``arg`` (a seq axis, maybe data
    and model axes) on the jobs sp.json lists for that mesh: (zip name,
    epochs, compressed); each rank feeds its rows and time chunk."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    with open("sp.json") as f:
        jobs = json.load(f)[arg]
    out = {}
    for name, epochs, compressed in jobs:
        d = np.load(f"{name}.npz")
        net = _net(name)
        pw = ParallelWrapper(net, _mesh(arg), prefetch_buffer=0,
                             dcn_compression={"threshold": 0.0}
                             if compressed else None)
        loc = lambda k, **kw: (pw.local_shard(d[k], **kw) if k in d
                               else None)
        ds = DataSet(loc("x", temporal=True), loc("y"),
                     loc("fm", temporal=True), loc("lm"))
        pw.fit(ListDataSetIterator([ds]), epochs=epochs)
        tag = name + ("_int8" if compressed else "")
        out[tag] = _flat(net)
        out[tag + "_loss"] = np.float32(net.score_value)
        out[tag + "_describe"] = np.array(json.dumps(pw.describe()))
    return out


def sc_pp(rank, world, arg):
    """``NetworkSpmdPipeline`` at pp = world, 4 microbatches: pp.json
    names the zips and their step counts; params after
    ``collect_params``, the losses, the stage split."""
    from deeplearning4j_tpu_torch.parallel.pipeline_spmd import (
        NetworkSpmdPipeline)
    with open("pp.json") as f:
        jobs = json.load(f)
    out = {}
    mesh = _mesh(f"data=1,pipe={world}")
    for name, steps in jobs:
        d = np.load(f"{name}.npz")
        net = _net(name)
        bridge = NetworkSpmdPipeline(net, mesh, n_microbatches=4)
        losses = [bridge.train_batch(d["x"], d["y"]) for _ in range(steps)]
        bridge.collect_params()
        out[name] = _flat(net)
        out[name + "_losses"] = np.array(losses, np.float64)
        out[name + "_describe"] = np.array(json.dumps(bridge.describe()))
        from deeplearning4j_tpu_torch.util.tree import tree_flat_vector
        out[name + "_state"] = np.asarray(tree_flat_vector(net.state),
                                          np.float32)
    return out


def sc_elastic(rank, world, arg):
    """ElasticTrainer over ParallelWrapper on a dp x tp mesh ``arg``:
    6 global batches of elastic.npz, a ``parallel.device`` loss at the
    3rd (the last rank's dp row drops out); then a fresh trainer on the
    full mesh resumes from the checkpoint and trains the epoch again."""
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.train.fault_tolerance import ElasticTrainer
    d = np.load("elastic.npz")
    spec = arg.replace("dp=", "data=").replace("tp=", "model=")

    def build():
        net = _net("elastic")
        pw = ParallelWrapper(net, _mesh(spec), prefetch_buffer=0)
        rows = [DataSet(pw.local_shard(d["x"][i:i + 8], temporal=False),
                        pw.local_shard(d["y"][i:i + 8], temporal=False))
                for i in range(0, 48, 8)]
        return net, pw, rows

    net, pw, rows = build()
    tr = ElasticTrainer(net, "ck", save_every=2, handle_sigterm=False,
                        wrapper=pw)
    chaos.install({"faults": [{"site": "parallel.device", "kind": "loss",
                               "at": [3]}]}, seed=0)
    try:
        tr.fit(ListDataSetIterator(rows), epochs=1)
    finally:
        chaos.uninstall()
    out = {"active": pw.active, "it": np.int64(net.iteration_count),
           "shape": np.array([pw.mesh.shape["data"],
                              pw.mesh.shape["model"]]),
           "p": _flat(net)}
    net2, pw2, rows = build()
    tr2 = ElasticTrainer(net2, "ck", save_every=2, handle_sigterm=False,
                         wrapper=pw2)
    out["resumed_it"] = np.int64(net2.iteration_count)
    tr2.fit(ListDataSetIterator(rows), epochs=1)
    out["shape_restart"] = np.array([pw2.mesh.shape["data"],
                                     pw2.mesh.shape["model"]])
    out["p_after_restart"] = _flat(net2)
    return out


def sc_serve(rank, world, arg):
    """``ModelServer(mesh=arg)`` on rank 0 over serve.zip, the other
    ranks following: predicts through the proxy and the scheduler, a
    batch the leader refuses, one that fails in every rank's forward
    and a predict after both; and the unsharded model's output on the
    same rows."""
    from deeplearning4j_tpu_torch.serving import tp_backend
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    d = np.load("serve.npz")
    registry = ModelRegistry()
    registry.register("m", _net("serve"))
    ref = _net("serve")
    want = ref.output(d["x"]).numpy()
    if rank != 0:
        tp_backend.host_models(registry, arg)
        n = tp_backend.follow()
        return {"forwards": np.int64(n), "want": want}
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    server = ModelServer(registry, max_batch_size=8, mesh=arg)
    try:
        model, _ = server.resolve_serving_model("m")
        got = model.output(d["x"]).numpy()
        bad = np.repeat(d["x"][:2, :, None], 2, axis=2)   # not (B, T) ids
        try:
            model.output(bad)
            checked = ""
        except ValueError as e:          # refused before the header
            checked = str(e)
        try:                             # past the check: every rank's
            model._run(model._padded(bad))     # forward raises alike
            failed = ""
        except Exception as e:
            failed = type(e).__name__
        after = model.output(d["x"]).numpy()
        sched, _ = server.scheduler_for("m")
        one = np.asarray(sched.predict(d["x"][:3], timeout=60))
        desc = json.dumps(model.mesh_desc())
        health = json.dumps(server.mesh_plan.describe())
        refused = ""
        try:
            server.batcher_for("m")
        except Exception as e:           # ServingError
            refused = str(e)
        # a bucket no request ran (16 rows), then again; the one the
        # predicts ran (pow2 of the batch's rows)
        warm = [model.warmup_bucket(16, d["x"].shape[1:]),
                model.warmup_bucket(16, d["x"].shape[1:]),
                model.warmup_bucket(len(d["x"]), d["x"].shape[1:])]
        shut = model.shutdown(drain=True, timeout=5.0)
        evicted = server.evict_model("m")
        gone = ""
        try:
            server.resolve_serving_model("m")
        except Exception as e:           # the tp wrap went with it
            gone = str(e)
    finally:
        server.stop(drain=True)
    return {"got": got, "one": one, "want": want, "after": after,
            "checked": np.array(checked), "failed": np.array(failed),
            "describe": np.array(desc), "health": np.array(health),
            "refused": np.array(refused), "warm": np.array(warm),
            "shut": np.array(shut), "evicted": np.array(evicted),
            "gone": np.array(gone)}


def sc_card(rank, world, arg):
    """On card 0, two gloo ranks: the tp=2 eager step of the LM in
    card.zip (3 Adam steps) against the one-rank step on the same card;
    the ring's kernel path (sp=2) against the flash attention's plain
    versions over the whole sequence on the same CUDA inputs (this
    rank's chunk of the output and of the q/k/v gradients)."""
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        build_mesh_context)
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_self_attention)
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    d = np.load("card.npz")
    out = {}
    ctx = build_mesh_context("sp=2", allow_sp=True)
    grp = ctx.seq_group()
    full = {n: torch.from_numpy(d[n]).cuda() for n in ("q", "k", "v", "do",
                                                       "mask")}
    loc = lambda t: ctx.local_shard(t).contiguous()
    for causal in (False, True):
        q, k, v = (loc(full[n]).requires_grad_(True) for n in "qkv")
        o = ring_self_attention(q, k, v, group=grp, causal=causal,
                                kv_mask=loc(full["mask"]))
        (o * loc(full["do"])).sum().backward()
        got = [o.detach()] + [t.grad for t in (q, k, v)]
        o_p, lse_p = attn.flash_attention_fwd_plain(
            full["q"], full["k"], full["v"], full["mask"], causal=causal)
        grads_p = attn.flash_attention_bwd_plain(
            full["q"], full["k"], full["v"], o_p, lse_p, full["do"],
            full["mask"], causal=causal)
        want = [loc(t) for t in (o_p,) + tuple(grads_p)]
        out[f"ring_c{int(causal)}"] = np.array(
            [float((a - b).abs().max()) for a, b in zip(got, want)])
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        make_ring_attention_fn)
    try:
        make_ring_attention_fn(grp, use_kernels="never")(q, k, v)
        refused = ""
    except ValueError as e:               # plain chunks: CPU only
        refused = str(e)
    out["refused"] = np.array(refused)
    out["fwd_launches"] = np.int64(attn.flash_attention_fwd_cuda.launches)
    x, y = d["ids"], d["y"]
    nets = {}
    for tag, spec in (("one", None), ("tp", "tp=2")):
        net = restore_model("card.zip", device="cuda:0")
        for i in range(3):
            net.fit(DataSet(x, y), mesh_spec=spec if i == 0 else None)
        nets[tag] = net.params_flat()
    out["tp_vs_one"] = np.float64(np.abs(nets["tp"] - nets["one"]).max())
    out["scale"] = np.float64(np.abs(nets["one"]).max())
    return out


SCENARIOS = {n[3:]: f for n, f in list(globals().items())
             if n.startswith("sc_")}


def result_name(full: str) -> str:
    """The file stem a scenario's results go under: its name, and its
    mesh when it names one (``sp:data=2,seq=2`` -> ``sp@data=2,seq=2``)."""
    name, _, arg = full.partition(":")
    return f"{name}@{arg}" if arg else name


def main():
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, process_count, process_index)
    out_dir, names = sys.argv[1], sys.argv[2:]
    os.chdir(out_dir)
    card = names == ["card"]
    assert initialize_distributed(device="cuda:0" if card else "cpu",
                                  backend="gloo")
    rank, world = process_index(), process_count()
    for full in names:
        name, _, arg = full.partition(":")
        res = SCENARIOS[name](rank, world, arg or None)
        np.savez(f"{result_name(full)}_rank{rank}.npz", **res)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
