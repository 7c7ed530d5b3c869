"""The port's request tracing (deeplearning4j_tpu_torch/observability/
tracing.py) against the JAX package's: W3C ``traceparent`` parsing and
emission (bad headers included), the head sampler's decisions over 1000
fixed trace ids (route overrides, always-sample on error), the phase
ledger of one scripted request through each backend, and the tracer's
``export_since`` paging. Everything compared is exact (strings, bools,
phase names and orders, span counts); no tolerance applies.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.observability import tracing as jtr
from deeplearning4j_tpu_torch.observability import tracing as ttr

HEADERS = [
    None, "", "garbage",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01",
    "  00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-03  ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-1",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01-extra",
    "00-zzf7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
]


def _ids(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return [f"{int(a):016x}{int(b):016x}" for a, b in
            rng.integers(0, 2 ** 63, (n, 2), dtype=np.int64)]


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_traceparent_parse_and_emit_match_jax(header, rate):
    got = []
    for mod in (jtr, ttr):
        ctx = mod.RequestContext.from_traceparent(
            header, "/v1/predict", mod.Sampler(rate=rate))
        if ctx is None:
            got.append(None)
            continue
        # the emitted header names this hop's own root span: compare
        # everything but that span id
        ver, tid, span, flags = ctx.traceparent().split("-")
        got.append((ctx.trace_id, ctx.parent_id, ctx.sampled, ver, tid,
                    len(span), flags))
    assert got[0] == got[1]


def test_minted_context_emits_a_valid_header():
    s = ttr.Sampler(rate=1.0)
    ctx = ttr.RequestContext.new("/v1/generate", s)
    again = jtr.RequestContext.from_traceparent(ctx.traceparent(),
                                                "/v1/generate")
    assert again.trace_id == ctx.trace_id
    assert again.parent_id == ctx.root_span_id and again.sampled


def test_sampler_decisions_match_jax_over_fixed_ids():
    routes = {"/v1/generate": 0.5, "/v1/embed": 0.0}
    ids = _ids()
    for rate in (0.0, 0.01, 0.1, 0.37, 1.0):
        js, ts = jtr.Sampler(rate, routes), ttr.Sampler(rate, routes)
        for route in (None, "/v1/predict", "/v1/generate", "/v1/embed"):
            want = [js.sample(t, route) for t in ids]
            assert [ts.sample(t, route) for t in ids] == want
    # the decision is a pure function of the id: a mid rate samples a
    # share near the rate, the same share in both packages
    share = np.mean([ttr.Sampler(0.1).sample(t) for t in ids])
    assert 0.05 < share < 0.15


def test_error_promotes_an_unsampled_trace_in_both():
    for mod in (jtr, ttr):
        ctx = mod.RequestContext.new("/v1/predict", mod.Sampler(0.0))
        assert not ctx.sampled and ctx.traceparent().endswith("-00")
        ctx.set_error(ValueError("boom"))
        assert ctx.sampled and ctx.traceparent().endswith("-01")
        assert ctx.error == repr(ValueError("boom"))


def _scripted(mod, backend):
    """One request through a backend's phases, as the HTTP handler,
    the worker thread and the waiter stamp them."""
    tracer = mod.Tracer()
    ctx = mod.RequestContext.new("/v1/" + backend, mod.Sampler(1.0),
                                 tracer=tracer)
    ctx.open_root()
    with ctx.attach():
        assert mod.current_context() is ctx
        ctx.phase_done("admission", now_in="queue_wait")
    assert mod.current_context() is None
    if backend == "predict":
        ctx.phase_done("queue_wait", now_in="batch_form")
        ctx.phase_done("batch_form", now_in="device_step",
                       attrs={"batch_rows": 3})
        ctx.phase_done("device_step", now_in="respond")
    else:
        ctx.phase_done("queue_wait", now_in="prefill",
                       attrs={"slot": 0, "prefix_hit_tokens": 8})
        ctx.phase_done("prefill", now_in="decode")
        ctx.phase_done("decode", now_in="respond", attrs={"tokens": 4})
    phase = ctx.current_phase()
    ctx.phase_done("respond")
    total = ctx.finish(attrs={"http_status": 200})
    assert total >= sum(v for k, v in ctx.phases.items()
                        if k != "finalize")
    spans = [(e["name"], e.get("args", {}).get("batch_rows"),
              e.get("args", {}).get("prefix_hit_tokens"))
             for e in tracer.events()]
    return list(ctx.phases), phase, spans, sorted(ctx.to_debug())


@pytest.mark.parametrize("backend", ["predict", "generate"])
def test_phase_ledger_names_and_order_match_jax(backend):
    assert _scripted(jtr, backend) == _scripted(ttr, backend)


def test_export_since_pages_like_jax():
    pages = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(buffer_limit=64)
        for i in range(100):
            tracer.record_span(f"s{i}", i * 1000, 10,
                               trace_id=f"{i:032x}")
        out, cursor = [], 0
        while True:
            page = tracer.export_since(since=cursor, limit=7)
            out.append((len(page["spans"]), page["next"], page["head"],
                        page["dropped"],
                        [s["name"] for s in page["spans"]]))
            if not page["spans"]:
                break
            cursor = page["next"]
        pages.append(out)
        assert tracer.events_for_trace(f"{99:032x}")[0]["name"] == "s99"
    assert pages[0] == pages[1]
    assert sum(n for n, *_ in pages[1]) == 64
