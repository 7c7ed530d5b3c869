"""The port's ring attention against the JAX package's, on the CPU.

The port's ring runs over gloo ranks (``tests/torch_mp_worker.py``),
each holding its chunk of the sequence; the JAX package's
``attention_reference`` and ``make_ring_attention_fn`` (over the 8
virtual CPU devices ``tests/conftest.py`` forces) see the same numpy
inputs. On the CPU each chunk runs the flash kernels' plain versions.
Tolerance: rtol 2e-4, atol 2e-5 (``tests/test_parallel.py``'s sp=8
ring attention) on outputs and gradients.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.parallel import ring_attention as jring
from deeplearning4j_tpu.parallel.mesh import MeshSpec, build_mesh
from deeplearning4j_tpu_torch.parallel import ring_attention as tring

import torch_dp_worker as worker
import torch_mp_worker as mp

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 8,
                                 reason="needs 8 virtual devices")]

RTOL, ATOL = 2e-4, 2e-5
B, T, H, D = 2, 16, 2, 8


def _inputs():
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((B, T), np.float32)
    mask[0, 9:] = 0.0          # a padded tail
    mask[1, :5] = 0.0          # keys dead in the first chunks only
    return q, k, v, do, mask


def _jax_masked_reference(q, k, v, mask, causal):
    """Softmax attention with masked keys out of the softmax and
    padded query rows zeroed (the layers' contract); a row with no live
    key is 0."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    live = jnp.ones((T, T), bool)
    if causal:
        live = jnp.tril(live)
    live = live[None, None] & (mask[:, None, None, :] > 0)
    s = jnp.where(live, s, -jnp.inf)
    m = jnp.max(s, -1, keepdims=True)
    p = jnp.where(live, jnp.exp(s - jnp.where(jnp.isfinite(m), m, 0.0)),
                  0.0)
    p = p / jnp.maximum(p.sum(-1, keepdims=True), 1e-30)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v) * mask[:, :, None, None]


def _jax_ref(causal, masked):
    q, k, v, do, mask = _inputs()
    if masked:
        f = lambda q, k, v: _jax_masked_reference(q, k, v, mask, causal)
    else:
        f = lambda q, k, v: jring.attention_reference(q, k, v,
                                                      causal=causal)
    o, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    q, k, v, do, mask = _inputs()
    out = {}
    for world in (2, 4, 8):
        d = tmp_path_factory.mktemp(f"ring{world}")
        np.savez(d / "ring.npz", q=q, k=k, v=v, do=do, mask=mask)
        worker.launch(world, d, ["ring"], timeout=120,
                      argv=mp_argv(d, ["ring"]))
        ranks = worker.load(d, "ring", world)
        out[world] = {key: np.concatenate([r[key] for r in ranks], axis=1)
                      for key in ranks[0]}
    return out


def mp_argv(d, scenarios):
    import sys
    return [sys.executable, mp.__file__, str(d)] + list(scenarios)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ring_matches_jax_outputs_and_grads(runs, world, causal, masked):
    """Outputs and q/k/v gradients against JAX's plain attention (masked:
    keys out of the softmax, padded query rows zeroed)."""
    got = runs[world]
    tag = f"c{int(causal)}m{int(masked)}"
    want = _jax_ref(causal, masked)
    for key, w in zip(("", "_dq", "_dk", "_dv"), want):
        np.testing.assert_allclose(got[tag + key], w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_ring_fn_matches_jax_ring(runs, world):
    """``make_ring_attention_fn`` (causal) against the JAX package's own
    ring over ``world`` virtual devices."""
    q, k, v, _, _ = _inputs()
    mesh = build_mesh(MeshSpec(data=1, seq=world), jax.devices()[:world])
    want = np.asarray(jring.make_ring_attention_fn(mesh, causal=True)(
        q, k, v))
    np.testing.assert_allclose(runs[world]["fn"], want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_masked_ring_matches_the_jax_ring(runs, world, causal):
    """The masked ring (the key-mask chunk rotating with its k/v) against
    the JAX package's ``ring_self_attention`` over ``world`` devices:
    outputs and q/k/v gradients."""
    q, k, v, do, mask = _inputs()
    mesh = build_mesh(MeshSpec(data=1, seq=world), jax.devices()[:world])
    try:
        from jax import shard_map
    except ImportError:                  # older jax
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    spec = P(None, "seq")

    def f(a, b, c):
        return shard_map(
            lambda a, b, c, m: jring.ring_self_attention(
                a, b, c, axis_name="seq", causal=causal, kv_mask=m)
            * m[:, :, None, None],
            mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)(
                a, b, c, jnp.asarray(mask))

    o, vjp = jax.vjp(f, q, k, v)
    want = [o] + list(vjp(jnp.asarray(do)))
    tag = f"c{int(causal)}m1"
    for key, w in zip(("", "_dq", "_dk", "_dv"), want):
        np.testing.assert_allclose(runs[world][tag + key], np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def _plain_merge_case(sentinel):
    """A row whose keys are all masked in chunk a and live in chunk b:
    chunk a carries lse = ``sentinel``, o = 0."""
    rng = np.random.default_rng(3)
    o_b = torch.from_numpy(rng.normal(size=(1, 2, 1, 4)).astype(np.float32))
    lse_b = torch.tensor([[[0.5, -1.25]]])
    o_a = torch.zeros_like(o_b)
    lse_a = torch.full_like(lse_b, sentinel)
    return o_a, lse_a, o_b, lse_b


@pytest.mark.parametrize("sentinel", [float("-inf"), -1e30])
def test_merge_gives_the_live_chunk_exactly(sentinel):
    o_a, lse_a, o_b, lse_b = _plain_merge_case(sentinel)
    for args in ((o_a, lse_a, o_b, lse_b), (o_b, lse_b, o_a, lse_a)):
        o, lse = tring._merge_chunks(*args)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
        np.testing.assert_array_equal(o.numpy(), o_b.numpy())
        np.testing.assert_array_equal(lse.numpy(), lse_b.numpy())
    # the JAX merge on the same row (its sentinel is -inf)
    jo, jl = jring._merge_chunks(jnp.asarray(o_a.numpy()),
                                 jnp.asarray(lse_a.numpy()),
                                 jnp.asarray(o_b.numpy()),
                                 jnp.asarray(lse_b.numpy()))
    np.testing.assert_allclose(np.asarray(jo), o_b.numpy(), rtol=0,
                               atol=ATOL)


def test_merge_of_two_dead_chunks_is_zero_not_nan():
    o = torch.zeros((1, 2, 1, 4))
    for s_a, s_b in ((float("-inf"), float("-inf")),
                     (float("-inf"), -1e30), (-1e30, -1e30)):
        out, lse = tring._merge_chunks(o, torch.full((1, 1, 2), s_a),
                                       o, torch.full((1, 1, 2), s_b))
        assert not torch.isnan(out).any() and not torch.isnan(lse).any()
        assert (out == 0).all()


def test_blockwise_and_reference_match_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 50, 2, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        want = np.asarray(jring.attention_reference(q, k, v, causal=causal))
        ref = tring.attention_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v)),
                                        causal=causal).numpy()
        blk = tring.blockwise_attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)),
                                        block_size=16,
                                        causal=causal).numpy()
        np.testing.assert_allclose(ref, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(blk, want, rtol=RTOL, atol=ATOL)


def test_sequence_parallel_routes_the_layer_through_the_ring():
    """Inside ``sequence_parallel`` the attention layer rides the ring
    (here a ring of one rank: exactly the layer's own attention), the
    context is visible only there, and ``make_ring_attention_fn``'s plain
    route equals JAX's reference."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
        SelfAttentionLayer)
    from deeplearning4j_tpu_torch.parallel import seq_context
    from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
    ring = RankGroup(None, None, [0], 0, "gloo")
    layer = SelfAttentionLayer(n_out=16, n_heads=2, causal=True)
    params, _ = layer.initialize(torch.Generator().manual_seed(0),
                                 InputType.recurrent(16, 8))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, 16)).astype(np.float32))
    mask = torch.ones(2, 8)
    mask[1, 5:] = 0.0
    want, _ = layer.apply(params, {}, x, mask=mask)
    assert seq_context.current_seq_axis() is None
    with seq_context.sequence_parallel(ring):
        assert seq_context.current_seq_axis() is ring
        assert seq_context.current_loss_axes() is ring
        got, _ = layer.apply(params, {}, x, mask=mask)
    assert seq_context.current_loss_axes() is None
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    q, k, v, _, _ = _inputs()
    fn = tring.make_ring_attention_fn(ring, causal=True, use_kernels="never")
    out = fn(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jring.attention_reference(q, k, v,
                                                          causal=True)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [{"scale": 0.5}, {"use_kernels": "never"}])
def test_plain_chunks_take_cpu_tensors_only(kw):
    """Off the CPU the ring runs the flash kernels or raises: another
    scale, or ``use_kernels='never'``, is refused before a chunk runs
    (meta tensors stand for a card's here); the kernels' own 1/sqrt(D)
    given as ``scale`` keeps the kernels."""
    from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
    ring = RankGroup(None, None, [0], 0, "gloo")
    q = torch.empty(1, 4, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        tring.make_ring_attention_fn(ring, **kw)(q, q, q)
    assert tring._plain_scale(q, 0.25) is None
