"""The port's gradient compression against the JAX package's, on the CPU.

The point-to-point codec (``int8_quantize_ef`` / ``int8_dequantize``)
and ``ThresholdCompressor`` run on the same seeded numpy inputs in both
packages and must agree bit for bit: the codes, the float32 scale and
the float32 residual, for float32 and bfloat16 inputs (a bfloat16 input
is carried in float32 first in both). The collective half runs at world
size 2 on gloo, in two spawned processes, against the JAX package's
``int8_all_reduce_ef`` / ``int8_all_reduce`` under ``shard_map`` over
two CPU devices. There the JAX side is jitted, and XLA computes
``absmax / 127`` as a product with the reciprocal, which can be one ulp
off the quotient (the port divides, as the JAX package's eager ops do);
so the summed int8 codes must be equal, and the totals and residuals
may differ by what one ulp of the scale moves: 2 ulps of a total,
``127 * 2 ulp(scale)`` of a residual.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from deeplearning4j_tpu.parallel import compression as jc
from deeplearning4j_tpu_torch.parallel import compression as tc
from torch_dp_worker import free_port

pytestmark = pytest.mark.ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, shape=(37, 19)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    r = (rng.normal(size=shape) * 0.05).astype(np.float32)
    return x, r


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("threshold", [0.0, 0.2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_ef_bit_equal_to_jax(seed, threshold, dtype):
    x, r = _inputs(seed)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj, rj = jc.int8_quantize_ef(xj, jnp.asarray(r), threshold)
    qt, st, rt = tc.int8_quantize_ef(xt, torch.from_numpy(r), threshold)
    assert qt.dtype == torch.int8 and rt.dtype == torch.float32
    assert st.dtype == torch.float32 and st.shape == ()
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert _bits(st.numpy()) == _bits(np.float32(sj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    # the wire pair decodes to the same values, in either dtype
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        dj = np.asarray(jc.int8_dequantize(qj, sj, jd), np.float32)
        dt = tc.int8_dequantize(qt, st, td).to(torch.float32).numpy()
        np.testing.assert_array_equal(_bits(dt), _bits(dj))
    # the EF invariant: residual == (x + r) - dequant(q), in float32
    g = xt.to(torch.float32) + torch.from_numpy(r)
    np.testing.assert_array_equal(
        _bits(rt.numpy()),
        _bits((g - tc.int8_dequantize(qt, st)).numpy()))


def test_quantize_ef_zero_input_scale_one():
    z = np.zeros((5,), np.float32)
    qj, sj, rj = jc.int8_quantize_ef(jnp.asarray(z), jnp.asarray(z))
    qt, st, rt = tc.int8_quantize_ef(torch.from_numpy(z),
                                     torch.from_numpy(z))
    assert float(st) == float(sj) == 1.0
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_quantize_ef_round_half_to_even():
    """Values landing exactly on .5 quanta round to even, as jnp.round
    does (torch.round's rule too)."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    z = np.zeros_like(x)
    qj, _, _ = jc.int8_quantize_ef(jnp.asarray(x), jnp.asarray(z))
    qt, _, _ = tc.int8_quantize_ef(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qt.numpy(), [127, 0, 2, 2, 0, -2, -2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_compressor_matches_jax(seed):
    jt = jc.ThresholdCompressor(threshold=0.5)
    tt = tc.ThresholdCompressor(threshold=0.5)
    rng = np.random.default_rng(seed)
    rj = jnp.zeros((64,), jnp.float32)
    rt = torch.zeros(64)
    for step in range(6):
        g = (rng.normal(size=64) * (0.05 if step % 3 == 2 else 0.6)
             ).astype(np.float32)
        qj, rj, dj = jt.encode(jnp.asarray(g), rj)
        qt, rt, dt = tt.encode(torch.from_numpy(g), rt)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
        assert float(dt) == float(dj)
        jt.maybe_adapt(float(dj))
        tt.maybe_adapt(float(dt))
        assert tt.threshold == jt.threshold


def test_threshold_compressor_adapt_edges():
    for density in (0.0, 0.05, 0.1, 0.5):
        jt = jc.ThresholdCompressor(threshold=1e-5, min_threshold=1e-5)
        tt = tc.ThresholdCompressor(threshold=1e-5, min_threshold=1e-5)
        for _ in range(3):
            jt.maybe_adapt(density)
            tt.maybe_adapt(density)
        assert tt.threshold == jt.threshold


# ---------------------------------------------------------------------------
# the collective half: world size 2 on gloo vs shard_map over 2 devices
# ---------------------------------------------------------------------------

_RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import compression as tc

    rank, port, src, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    data = np.load(src)
    x, r, y = (torch.from_numpy(data[k][rank]) for k in ("x", "r", "y"))
    res = {}
    for thr in (0.0, 0.2):
        tot, nr = tc.int8_all_reduce_ef(x, r, None, threshold=thr)
        res[f"ef_tot_{thr}"], res[f"ef_res_{thr}"] = tot, nr
    res["plain"] = tc.int8_all_reduce(x, None)
    res["plain_thr"] = tc.make_compressed_psum(0.2)({"a": [x]}, None)["a"][0]
    tree, resid = tc.make_compressed_psum_ef(0.2)(
        {"w": x, "b": [y]}, {"w": r, "b": [torch.zeros_like(y)]}, None)
    res["tree_w"], res["tree_b"] = tree["w"], tree["b"][0]
    res["tree_rw"], res["tree_rb"] = resid["w"], resid["b"][0]
    dist.destroy_process_group()
    np.savez(out, **{k: v.numpy() for k, v in res.items()})
""")


def _jax_collective(x, r, y):
    mesh = Mesh(np.array(jax.devices()[:2]), ("d",))
    out = {}
    for thr in (0.0, 0.2):
        def ef(a, res, thr=thr):
            tot, nr = jc.int8_all_reduce_ef(a[0], res[0], "d",
                                            threshold=thr)
            return tot, nr[None]
        tot, nr = jax.jit(shard_map(
            ef, mesh=mesh, in_specs=(P("d"), P("d")),
            out_specs=(P(), P("d"))))(x, r)
        out[f"ef_tot_{thr}"], out[f"ef_res_{thr}"] = tot, nr
    out["plain"] = jax.jit(shard_map(
        lambda a: jc.int8_all_reduce(a[0], "d"), mesh=mesh,
        in_specs=P("d"), out_specs=P()))(x)
    out["plain_thr"] = jax.jit(shard_map(
        lambda a: jc.make_compressed_psum(0.2)({"a": [a[0]]}, "d")["a"][0],
        mesh=mesh, in_specs=P("d"), out_specs=P()))(x)

    def tree_fn(a, b, res):
        tree, resid = jc.make_compressed_psum_ef(0.2)(
            {"w": a[0], "b": [b[0]]},
            {"w": res[0], "b": [jnp.zeros_like(b[0])]}, "d")
        return (tree["w"], tree["b"][0], resid["w"][None],
                resid["b"][0][None])
    (out["tree_w"], out["tree_b"], out["tree_rw"],
     out["tree_rb"]) = jax.jit(shard_map(
         tree_fn, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
         out_specs=(P(), P(), P("d"), P("d"))))(x, y, r)
    return {k: np.asarray(v) for k, v in out.items()}


def test_collective_half_matches_jax_shard_map(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 96)).astype(np.float32)
    r = (rng.normal(size=(2, 96)) * 0.05).astype(np.float32)
    y = rng.normal(size=(2, 10)).astype(np.float32)
    src = str(tmp_path / "in.npz")
    np.savez(src, x=x, r=r, y=y)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(rank), port, src,
         str(tmp_path / f"rank{rank}.npz")], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    try:
        logs = [p.communicate(timeout=60)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [np.load(str(tmp_path / f"rank{i}.npz")) for i in range(2)]
    want = _jax_collective(x, r, y)
    ulp = 2.0 ** -23
    scales = {"ef_tot_0.0": np.abs(x + r).max() / np.float32(127),
              "ef_tot_0.2": np.abs(x + r).max() / np.float32(127),
              "plain": np.abs(x).max() / np.float32(127),
              "plain_thr": np.abs(x).max() / np.float32(127),
              "tree_w": np.abs(x + r).max() / np.float32(127),
              "tree_b": np.abs(y).max() / np.float32(127)}
    for key, scale in scales.items():
        for got in ranks:       # every rank holds the same total
            np.testing.assert_array_equal(
                np.round(got[key] / scale), np.round(want[key] / scale),
                err_msg=key)
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=2 * ulp, atol=0, err_msg=key)
    for key, tot in (("ef_res_0.0", "ef_tot_0.0"),
                     ("ef_res_0.2", "ef_tot_0.2"),
                     ("tree_rw", "tree_w"), ("tree_rb", "tree_b")):
        for i, got in enumerate(ranks):   # each rank its own residual
            np.testing.assert_allclose(
                got[key], want[key][i], rtol=0,
                atol=127 * 2 * ulp * scales[tot], err_msg=key)
