"""The port's chaos and resilience layer against the JAX package's, on
the CPU: fault plans accepted and refused alike, the same ``(plan,
seed)`` firing at the same hit numbers, ``checkpoint.write`` faults
raising the same error types at restore, ``retrying_io`` retrying
``data.fetch`` the same way, the circuit breaker's transitions on one
scripted sequence of failures, successes and clock ticks, the
weighted-fair picker's and the tier queue's order, and the worker-step
site in both serving backends (crash, poison). Everything compared is
exact (ordinals, states, types, ids); no tolerance applies.
"""

import queue

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu import chaos as jchaos
from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.observability.registry import REGISTRY as JREG
from deeplearning4j_tpu.serving import lifecycle as jlife
from deeplearning4j_tpu.serving import tiers as jtiers
from deeplearning4j_tpu.serving.continuous import (
    ContinuousBatcher as JaxBatcher)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos as tchaos
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.observability.registry import REGISTRY as TREG
from deeplearning4j_tpu_torch.serving import lifecycle as tlife
from deeplearning4j_tpu_torch.serving import tiers as ttiers
from deeplearning4j_tpu_torch.serving.continuous import ContinuousBatcher
from deeplearning4j_tpu_torch.serving.errors import CircuitOpenError
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler
from deeplearning4j_tpu_torch.util import model_serializer as tser

V, CAP, PS = 64, 32, 4


@pytest.fixture(autouse=True)
def _no_injector():
    yield
    jchaos.uninstall()
    tchaos.uninstall()


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(jax net, port net, zip path) of one small causal LM."""
    b = (NeuralNetConfiguration.builder().set_seed(0).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=32)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=2, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    jnet = JaxNet(conf).init()
    path = str(tmp_path_factory.mktemp("chaos") / "lm.zip")
    jser.write_model(jnet, path)
    return jnet, tser.restore_model(path, device="cpu"), path


PLANS = [
    [{"site": "serving.worker.step", "kind": "poison", "at": [3]}],
    {"seed": 4, "faults": [{"site": "checkpoint.write",
                            "kind": "truncate", "p": 0.5,
                            "args": {"keep_frac": 0.25}}]},
    '{"faults": [{"site": "data.fetch", "kind": "error", "p": 0.3}]}',
    [{"site": "serving.kv.migrate", "kind": "corrupt", "at": [1]},
     {"site": "ps.push.drop", "kind": "drop", "p": 1.0,
      "max_fires": 2}],
    [{"site": "serving.replica", "kind": "kill", "at": [2],
      "args": {"replica": 0}}],
    # refused: unknown site, a kind the site does not take, a spec that
    # can never fire, an unknown key, a plan of the wrong type
    [{"site": "serving.worker.stpe", "kind": "crash", "p": 1.0}],
    [{"site": "data.fetch", "kind": "poison", "p": 1.0}],
    [{"site": "checkpoint.read", "kind": "corrupt"}],
    [{"site": "data.fetch", "kind": "slow", "p": 1.0, "delay": 1}],
    42,
]


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_parse_plan_accepts_and_refuses_like_jax(plan):
    got = []
    for mod in (jchaos, tchaos):
        try:
            got.append(("ok", mod.parse_plan(plan).to_dict()))
        except Exception as e:      # the refusal's type is the contract
            got.append((type(e).__name__, None))
    assert got[0] == got[1]
    assert sorted(tchaos.SITES) == sorted(jchaos.SITES)


def _fire_pattern(mod, plan, seed, hits=200):
    inj = mod.FaultInjector(plan, seed=seed)
    sites = ["serving.worker.step", "data.fetch", "checkpoint.write"]
    fired = []
    for n in range(hits):
        f = inj.hit(sites[n % 3])
        if f is not None:
            fired.append((f.site, f.kind, f.ordinal))
    return fired, inj.counts(), inj.seed


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_same_plan_and_seed_fire_at_the_same_hits(seed):
    plan = {"faults": [
        {"site": "serving.worker.step", "kind": "crash", "p": 0.2},
        {"site": "serving.worker.step", "kind": "poison", "p": 0.3,
         "max_fires": 4},
        {"site": "data.fetch", "kind": "error", "at": [2, 5, 9]},
        {"site": "checkpoint.write", "kind": "corrupt", "p": 0.1}]}
    want = _fire_pattern(jchaos, plan, seed)
    assert _fire_pattern(tchaos, plan, seed) == want
    assert len(want[0]) > 5


@pytest.mark.parametrize("kind", ["truncate", "corrupt"])
def test_checkpoint_write_faults_raise_the_jax_error_types(
        lm, tmp_path, kind):
    jnet, tnet, _ = lm
    plan = [{"site": "checkpoint.write", "kind": kind, "at": [1]}]
    kinds = []
    for mod, ser, net in ((jchaos, jser, jnet), (tchaos, tser, tnet)):
        path = str(tmp_path / f"{mod.__name__}.zip")
        mod.install(plan, seed=0)
        ser.write_model(net, path)
        mod.uninstall()
        errs = {}
        for who, restore, verify in (
                ("jax", jser.restore_model, jser.verify_checkpoint),
                ("port", lambda p: tser.restore_model(p, device="cpu"),
                 tser.verify_checkpoint)):
            for what, fn in (("restore", restore), ("verify", verify)):
                with pytest.raises(Exception) as e:
                    fn(path)
                errs[(who, what)] = type(e.value).__name__
        kinds.append(errs)
        # one file, both packages' readers: the same error types
        assert errs[("jax", "restore")] == errs[("port", "restore")]
        assert errs[("jax", "verify")] == errs[("port", "verify")] == \
            "CheckpointIntegrityError"
    # and each package's own writer + reader agree with the other's
    assert kinds[0][("jax", "restore")] == kinds[1][("port", "restore")]


def test_checkpoint_read_error_is_transient_and_the_file_intact(lm):
    _, _, path = lm
    tchaos.install([{"site": "checkpoint.read", "kind": "error",
                     "at": [1]}], seed=0)
    with pytest.raises(tchaos.ChaosIOError):
        tser.restore_model(path, device="cpu")
    assert tser.restore_model(path, device="cpu") is not None
    assert tchaos.current().hits("checkpoint.read") == 2


def _fetch_run(chaos_mod, it_mod, reg, seed):
    plan = {"faults": [{"site": "data.fetch", "kind": "error",
                        "p": 0.4}]}
    chaos_mod.install(plan, seed=seed)
    ctr = reg.counter("retry_attempts_total",
                      help="transient failures retried with backoff",
                      labels={"policy": "io"})
    before = ctr.value
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    it = it_mod.ArrayDataSetIterator(x, x[:, :1], batch_size=3,
                                     shuffle=True, seed=1)
    batches = [np.asarray(b.features).tolist() for b in it]
    hits = chaos_mod.current().hits("data.fetch")
    chaos_mod.uninstall()
    return batches, hits, ctr.value - before


@pytest.mark.parametrize("seed", [0, 3])
def test_retrying_io_retries_data_fetch_like_jax(seed):
    want = _fetch_run(jchaos, jit, JREG, seed)
    got = _fetch_run(tchaos, tit, TREG, seed)
    assert got == want
    assert got[1] > len(got[0]) and got[2] == got[1] - len(got[0])


def _breaker_run(mod):
    clock = [0.0]
    br = mod.CircuitBreaker(failure_threshold=3, window_s=10.0,
                            cooldown_s=5.0, half_open_max=1,
                            clock=lambda: clock[0])
    seen = []
    br.on_transition = lambda old, new: seen.append((old, new, clock[0]))
    trail = []
    script = [("f", 1), ("f", 1), ("t", 11), ("f", 1), ("f", 0.5),
              ("s", 0), ("f", 0.5), ("a", 0), ("t", 2), ("a", 0),
              ("t", 3), ("a", 0), ("a", 0), ("f", 0), ("t", 4),
              ("a", 0), ("t", 1), ("a", 0), ("s", 0), ("a", 0),
              ("t", 6), ("a", 0), ("s", 0), ("f", 1), ("a", 0)]
    for op, dt in script:
        clock[0] += dt
        if op == "f":
            br.record_failure()
        elif op == "s":
            br.record_success()
        elif op == "a":
            trail.append(br.try_admit())
        trail.append((br.state, br.state_code(),
                      round(br.cooldown_remaining(), 9)))
    br.force_open()
    trail.append((br.state, br.opened_total))
    return trail, seen


def test_circuit_breaker_transitions_match_jax():
    want = _breaker_run(jlife)
    got = _breaker_run(tlife)
    assert got == want
    states = {new for _, new, _ in got[1]}
    assert states == {"open", "half_open", "closed"}


def test_weighted_fair_picker_and_tier_queue_match_jax():
    rng = np.random.default_rng(2)
    arrivals = [jtiers.TIERS[i] for i in rng.integers(0, 3, 300)]
    orders = []
    for tiers_mod, life in ((jtiers, jlife), (ttiers, tlife)):
        p = tiers_mod.WeightedFairPicker()
        backlog = {t: arrivals.count(t) for t in tiers_mod.TIERS}
        order = []
        while any(backlog.values()):
            t = p.pick([t for t in tiers_mod.TIERS if backlog[t]])
            backlog[t] -= 1
            order.append(t)
        q = life.TierQueue(maxsize=40)
        shed, evicted = 0, []

        class R:
            def __init__(self, i, tier):
                self.i, self.tier = i, tier
        for i, t in enumerate(arrivals[:60]):
            try:
                v = q.put_nowait(R(i, t))
                if v is not None:
                    evicted.append(v.i)
            except queue.Full:
                shed += 1
        served = []
        while not q.empty():
            served.append(q.get_nowait().i)
        orders.append((order, shed, evicted, served,
                       tiers_mod.parse_tier("best-effort"),
                       tiers_mod.priced_retry_after_s(0.5, "gold")))
    assert orders[0] == orders[1]
    gold_share = orders[1][0][:60].count("gold") / 60
    assert gold_share > 0.5


class _Twice:
    def output(self, x):
        return np.asarray(x) * 2


def test_scheduler_crash_opens_the_breaker_and_the_probe_closes_it():
    tchaos.install([{"site": "serving.worker.step", "kind": "crash",
                     "p": 1.0, "max_fires": 3}], seed=1)
    br = tlife.CircuitBreaker(failure_threshold=3, window_s=10.0,
                              cooldown_s=0.2, half_open_max=1)
    s = BatchScheduler(_Twice(), max_batch_size=4, queue_limit=16,
                       wait_ms=1.0, breaker=br, name="predict")
    try:
        for _ in range(3):
            with pytest.raises(tchaos.SimulatedCrashError):
                s.predict(np.ones((1, 4), np.float32))
        _wait_for(lambda: br.state == "open")
        with pytest.raises(CircuitOpenError) as e:
            s.submit(np.ones((1, 4), np.float32))
        assert 0 < e.value.retry_after_s <= 0.2
        reg = s.metrics.registry
        assert reg.get("serving_worker_crashes_total",
                       labels={"endpoint": "predict"}).value == 3
        assert reg.get("circuit_state",
                       labels={"endpoint": "predict"}).value() == 2
        _wait_for(lambda: br.state == "half_open")
        out = s.predict(np.ones((1, 4), np.float32))    # the probe
        np.testing.assert_array_equal(out, np.full((1, 4), 2.0))
        assert br.state == "closed"
        assert s._endpoint.errors == 3
    finally:
        assert s.shutdown()


def _wait_for(cond, timeout=10.0):
    import time
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "condition never held"
        time.sleep(0.005)


def _poison_run(batcher_cls, net, chaos_mod):
    # prompt [1, 2, 3]: steps 1-2 prefill, step 3 samples the first
    # token: poison THAT step
    chaos_mod.install([{"site": "serving.worker.step", "kind": "poison",
                        "at": [3]}], seed=1)
    cb = batcher_cls(net, slots=2, capacity=CAP, page_size=PS)
    try:
        in_use = cb.session.pages_in_use()
        with pytest.raises(ValueError, match="non-finite"):
            cb.generate(np.array([1, 2, 3]), 4)
        assert cb.session.pages_in_use() == in_use
        out = cb.generate(np.array([1, 2, 3]), 4)
        assert cb.breaker.state == "closed"   # per-slot, not a crash
        errors = cb._endpoint.errors
    finally:
        assert cb.drain()
        chaos_mod.uninstall()
    return np.asarray(out).tolist(), errors


def test_batcher_poison_fails_the_stream_and_returns_its_pages(lm):
    jnet, tnet, _ = lm
    assert _poison_run(ContinuousBatcher, tnet, tchaos) == \
        _poison_run(JaxBatcher, jnet, jchaos)


def test_batcher_crash_spares_pending_requests_like_jax(lm):
    jnet, tnet, _ = lm
    results = []
    for cls, net, mod, life in ((JaxBatcher, jnet, jchaos, jlife),
                                (ContinuousBatcher, tnet, tchaos, tlife)):
        mod.install([{"site": "serving.worker.step", "kind": "crash",
                      "at": [3]}], seed=1)
        cb = cls(net, slots=1, capacity=CAP, page_size=PS,
                 breaker=life.CircuitBreaker(failure_threshold=5))
        first = cb.submit(np.array([1, 2, 3]), 4, tier="gold")
        second = cb.submit(np.array([4, 5]), 3, tier="best_effort")
        with pytest.raises(mod.SimulatedCrashError):
            cb.wait(first)
        ids = np.asarray(cb.wait(second)).tolist()     # restarted loop
        assert cb.breaker.state == "closed"
        assert first.ctx.sampled and first.ctx.error.startswith(
            "SimulatedCrashError")
        crashes = cb.metrics.registry.get(
            "serving_worker_crashes_total",
            labels={"endpoint": "generate"}).value
        results.append((ids, crashes, cb.session.pages_in_use()))
        assert cb.drain()
        mod.uninstall()
    assert results[0] == results[1]
