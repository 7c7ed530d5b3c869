"""The port's training-health monitor, its fused health vector, the
flight recorder's health hook and the step profiler against the JAX
package, on the CPU.

``fused_health`` is held to JAX's on the same trees at float32
tolerance (atol 1e-5, rtol 1e-4: the same sums in another order), the
finite bits exactly. ``HealthMonitor`` gets the same sequence of health
vectors in both packages and must trip the same detectors at the same
iterations with the same policies. The profiler's MFU is JAX's formula
on the same inputs, so it is held equal to 1e-12 relative.
"""

import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.observability import health as jh
from deeplearning4j_tpu.observability import step_profile as jsp
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.observability import flight_recorder as tfr
from deeplearning4j_tpu_torch.observability import health as th
from deeplearning4j_tpu_torch.observability import step_profile as tsp
from deeplearning4j_tpu_torch.util import model_serializer as tser

ATOL, RTOL = 1e-5, 1e-4


def _trees(seed, poison=None):
    rng = np.random.default_rng(seed)
    trees = [[{"W": rng.normal(size=(4, 3)).astype(np.float32),
               "b": rng.normal(size=(3,)).astype(np.float32)}]
             for _ in range(3)]
    if poison is not None:
        which, value = poison
        trees[which][0]["W"][1, 2] = value
    return trees


@pytest.mark.parametrize("poison", [None, (0, np.nan), (1, np.inf),
                                    (2, -np.inf)])
@pytest.mark.parametrize("loss", [0.75, float("nan")])
def test_fused_health_matches_jax(poison, loss):
    import jax.numpy as jnp
    grads, updates, params = _trees(1, poison)
    want = np.asarray(jh.fused_health(
        jnp.float32(loss), grads, updates, params))
    conv = [[{k: torch.from_numpy(v) for k, v in t[0].items()}]
            for t in (grads, updates, params)]
    got = th.fused_health(torch.tensor(loss), *conv)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5,)
    got = got.numpy()
    assert got[th.H_BITS] == want[jh.H_BITS]
    np.testing.assert_allclose(got[1:], want[1:], atol=ATOL, rtol=RTOL,
                               equal_nan=True)


class _Model:
    """What the monitor reads off an executor: the step's health row."""
    _last_health = None
    _last_batch = None


def _run(mod, rows, **kw):
    mon = mod.HealthMonitor(**kw)
    model = _Model()
    events = []
    for it, row in enumerate(rows):
        model._last_health = None if row is None else np.float32(row)
        score = row[1] if row is not None else 1.0
        try:
            mon.iteration_done(model, it, score, 8)
        except mod.TrainingDivergedError as e:
            events.append(("raise", it, e.anomaly["kind"], e.rollback))
    return ([(a["kind"], a["iteration"], a["policy"])
             for a in mon.anomalies], events, mon.status()["status"],
            mon.device_fetches)


def _row(loss, g=1.0, bits=0.0):
    return [bits, loss, g, 0.01, 10.0]


SEQUENCES = {
    "divergence": [_row(1.0)] * 5 + [_row(50.0)] * 4,
    "plateau": [_row(0.5)] * 60,
    "grad_explosion": [_row(1.0, g)
                       for g in [1.0] * 14 + [500.0] + [1.0] * 3],
    "grad_vanish": [_row(1.0, 1e-12)] * 7,
    "non_finite": [_row(1.0)] * 3 + [_row(float("nan"), bits=3.0)]
    + [_row(1.0)] * 2,
    "heal": [_row(1.0)] * 2 + [_row(1.0, bits=2.0)] + [_row(1.0)] * 8,
}


@pytest.mark.parametrize("policy", ["warn", "raise", "rollback"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_monitor_trips_as_jax_does(name, policy, caplog):
    """The same health rows through both monitors: the same anomalies
    (detector, iteration, policy), the same raised errors and rollback
    flags, the same status and fetch count."""
    caplog.set_level(logging.CRITICAL)
    kw = {"policy": policy, "plateau_window": 50, "heal_after": 5}
    assert _run(th, SEQUENCES[name], **kw) == _run(jh, SEQUENCES[name],
                                                   **kw)


def test_monitor_without_a_vector_checks_the_score():
    rows = [None, None]
    mon_t, mon_j = th.HealthMonitor(), jh.HealthMonitor()
    for it, score in enumerate([1.0, float("nan")]):
        for mon in (mon_t, mon_j):
            mon.iteration_done(_Model(), it, score, 4)
    assert [a["kind"] for a in mon_t.anomalies] == [
        a["kind"] for a in mon_j.anomalies] == ["non_finite"]
    assert rows == [None, None]


def _pair(tmp_path):
    conf = (JaxBuilder.builder().set_seed(1).updater(jupd.sgd(0.1))
            .list().layer(jl.DenseLayer(n_out=6, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.feed_forward(4)).build())
    jn = JNet(conf).init()
    path = str(tmp_path / "h.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def _data(n, poison=None):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        x = rng.normal(size=(4, 4)).astype(np.float32)
        if i == poison:
            x[0, 0] = np.nan
        out.append((x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]))
    return out


def test_monitor_trips_at_the_poisoned_step_of_a_window(tmp_path):
    """A window of 4 with a NaN batch at index 2: both packages' monitors
    (raise policy) trip ``non_finite`` with the same bits at iteration
    2, and the executor points at window entry 2."""
    jn, tn = _pair(tmp_path)
    jm, tm = jh.HealthMonitor(policy="raise"), th.HealthMonitor(
        policy="raise")
    jn.set_listeners(jm)
    tn.set_listeners(tm)
    data = _data(4, poison=2)
    with pytest.raises(jh.TrainingDivergedError) as je:
        jn.fit_batches([JDataSet(x, y) for x, y in data],
                       steps_per_device_call=4)
    with pytest.raises(th.TrainingDivergedError) as te:
        tn.fit_batches([TDataSet(x, y) for x, y in data],
                       steps_per_device_call=4)
    for e in (je.value, te.value):
        assert e.anomaly["kind"] == "non_finite"
        assert e.anomaly["iteration"] == 2
    assert te.value.anomaly["value"] == je.value.anomaly["value"]
    assert tn._window_batch_index == jn._window_batch_index == 2
    assert tm.device_fetches == jm.device_fetches == 3
    np.testing.assert_allclose(tm.last["grad_norm"] or 0.0,
                               jm.last["grad_norm"] or 0.0)


def test_dead_activation_check_reads_feed_forward(tmp_path):
    """``check_activations_every`` runs the executor's ``feed_forward``
    on the last batch: the same dead fractions as JAX's."""
    jn, tn = _pair(tmp_path)
    jm = jh.HealthMonitor(check_activations_every=1, dead_threshold=2.0)
    tm = th.HealthMonitor(check_activations_every=1, dead_threshold=2.0)
    jn.set_listeners(jm)
    tn.set_listeners(tm)
    x, y = _data(1)[0]
    jn.fit(JDataSet(x, y))
    tn.fit(TDataSet(x, y))
    assert tm.last["dead_fraction"] == jm.last["dead_fraction"]


def test_recorder_gets_each_anomaly(tmp_path):
    """``HealthMonitor(recorder=...)``: the anomaly lands in the ring
    and a bundle is dumped."""
    rec = tfr.FlightRecorder(out_dir=str(tmp_path), min_dump_interval_s=0)
    try:
        mon = th.HealthMonitor(recorder=rec)
        model = _Model()
        model._last_health = np.float32(_row(float("nan"), bits=1.0))
        mon.iteration_done(model, 7, float("nan"), 4)
        kinds = [e["kind"] for e in rec.events()]
        assert "anomaly" in kinds
        assert any(p.name.startswith("postmortem-")
                   and "anomaly_non_finite" in p.name
                   for p in tmp_path.iterdir())
    finally:
        rec.close()


# ------------------------------------------------------------ profiler

@pytest.mark.parametrize("flops,rate,train", [(4.09e9, 1234.5, True),
                                              (2.3e6, 98765.0, False)])
def test_mfu_equals_jax(flops, rate, train):
    peak = tsp.peak_flops_for_kind("NVIDIA H100 80GB HBM3")
    assert peak == 989e12
    got = tsp.model_flops_utilization(flops, rate, train, peak)
    want = jsp.model_flops_utilization(flops, rate, train, peak)
    assert got == pytest.approx(want, rel=1e-12)
    assert tsp.model_flops_utilization(flops, rate, train, None) is None


def test_peak_table():
    assert tsp.peak_flops_for_kind("NVIDIA H100 PCIe") == 756e12
    assert tsp.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert tsp.peak_flops_for_kind("Tesla T4") is None


class _Timed:
    _step_timing = (0.002, 0.001)


def test_profiler_reports_as_jax(monkeypatch):
    """The same iterations through both listeners: the same report keys
    and step counts; ``mfu`` from the same formula."""
    monkeypatch.setattr(tsp, "detect_peak_flops",
                        lambda: (989e12, "NVIDIA H100 80GB HBM3"))
    monkeypatch.setattr(jsp, "detect_peak_flops",
                        lambda: (989e12, "NVIDIA H100 80GB HBM3"))
    out = {}
    for mod, score in ((tsp, torch.tensor(1.0)), (jsp, np.float32(1.0))):
        lst = mod.ProfilerListener(frequency=5, flops_per_sample=1e9,
                                   report=False)
        for it in range(16):
            lst.iteration_done(_Timed(), it, score, 32)
        out[mod.__name__] = lst.reports
    t, j = out[tsp.__name__], out[jsp.__name__]
    assert len(t) == len(j) == 3
    for a, b in zip(t, j):
        assert set(a) == set(b)
        assert a["steps"] == b["steps"] == 5
        assert a["data_wait_ms"] == b["data_wait_ms"] == 2.0
        assert a["mfu"] == pytest.approx(
            jsp.model_flops_utilization(1e9, a["samples_per_sec"], True,
                                        989e12), rel=1e-3)
