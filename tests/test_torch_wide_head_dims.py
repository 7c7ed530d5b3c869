"""Head dims past 128 against the JAX package, on the CPU.

The card's attention kernels run such a head dim through their wide
variants (``ops/native.kernel_head_dim``: D padded to a multiple of
128); here the port's wrappers take their plain versions. Seeded numpy
inputs at head dims 160 and 256 go through the JAX package and the
port: ``flash_attention`` (the JAX blockwise path on the CPU) forward
and gradients, causal and key-masked; a transformer network of two
heads of 160 carried across through ``write_model`` and the port's
loader (outputs, loss, gradients); and paged decode steps of the
attention layers (``apply_stream_paged``) on pools laid out as the
card's, at the padded width. Tolerance atol 2e-5, rtol 2e-4: float32 on
both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               SelfAttentionLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import decode_attention as tda
from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.util import model_serializer as tser

ATOL, RTOL = 2e-5, 2e-4
WIDE_DIMS = [160, 256]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("masked,causal", [(False, True), (True, True)])
def test_flash_attention_and_grads_match_jax(D, masked, causal):
    rng = np.random.default_rng(D + 2 * masked + causal)
    B, T, H = 2, 24, 2
    q, k, v, do = (rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, T // 2:] = 0
        mask[1, :5] = 0
    ref, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
        a, b, c, causal=causal, kv_mask=mask), q, k, v)
    ref_grads = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention(
        *t, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(do)).sum().backward()
    assert native.kernel_head_dim(D) == 256
    _close(out.detach().numpy(), ref)
    for got, want in zip(t, ref_grads):
        _close(got.grad.numpy(), want)


def _jax_net(D, heads=2, V=13, T=8):
    conf = (NeuralNetConfiguration.builder().set_seed(5)
            .updater(jupd.adam(1e-3)).list()
            .layer(EmbeddingSequenceLayer(n_in=V, n_out=heads * D))
            .layer(TransformerEncoderLayer(n_heads=heads, causal=True))
            .layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return JaxNet(conf).init()


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            jser._flatten_with_paths(tree).items()}


@pytest.mark.parametrize("D", [160])
def test_transformer_net_matches_jax(tmp_path, D):
    """Two heads of D carried across through the JAX package's zip: the
    output, the masked loss and every gradient (at 160, padded to 256
    on the card; the layer tests below take 256 too)."""
    V, T, B = 13, 8, 2
    jn = _jax_net(D, V=V, T=T)
    path = str(tmp_path / "net.zip")
    jser.write_model(jn, path)
    tn = tser.restore_model(path, device="cpu")
    rng = np.random.default_rng(D)
    ids = rng.integers(0, V, (B, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    lm = np.ones((B, T), np.float32)
    lm[1, 5:] = 0
    _close(tn.output(ids).numpy(), jn.output(ids))
    jds = JaxDataSet(ids, y, lm, lm)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jn._loss(p, jn.state, jn._batch_tuple(jds), None,
                           training=True), has_aux=True)(jn.params)
    tloss, tgrads, _ = tn._gradients(tn._batch_tuple(
        DataSet(ids, y, lm, lm)))
    _close(float(tloss), float(loss))
    want, got = _flat(grads), tser._flatten(tgrads)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("kind", ["attn", "block"])
def test_paged_decode_steps_match_jax(D, kind):
    """Three decode steps (t = 1) of 3 slots through ``apply_stream_paged``
    on pools allocated as the card's (the Dh-wide views of zeroed buffers
    at ``kernel_head_dim``'s width): the outputs and the pool writes
    against the JAX layer's."""
    H, ps, P, S = 2, 4, 4, 3
    width = H * D
    rng = np.random.default_rng(D + len(kind))
    if kind == "attn":
        jl = SelfAttentionLayer(n_in=width, n_out=width, n_heads=H,
                                causal=True, qkv_bias=True)
    else:
        jl = TransformerEncoderLayer(n_in=width, n_out=width, n_heads=H,
                                     causal=True)
    params, _ = jl.initialize(jax.random.PRNGKey(D),
                              InputType.recurrent(width))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)
    tl = tlayers.layer_from_dict(jl.to_dict())
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    init = {n: rng.normal(0, 1, (10, ps, H, D)).astype(np.float32)
            for n in ("k", "v")}
    jpool = {n: jnp.asarray(a) for n, a in init.items()}
    tpool = {}
    for n, a in init.items():
        tpool[n] = tda.zero_kv_pool(10, ps, H, D, padded=True)
        tpool[n].copy_(torch.from_numpy(a))
        assert tpool[n].stride(2) == native.kernel_head_dim(D)
    table = np.array([[3, 5, 7, 9], [2, 4, 6, 8], [1, 0, 0, 0]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    for step in range(3):
        x = rng.normal(0, 1, (S, 1, width)).astype(np.float32)
        ref, jpool = jl.apply_stream_paged(params, jpool, table, pos,
                                           x.copy())
        out, _ = tl.apply_stream_paged(tparams, tpool,
                                       torch.from_numpy(table),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(x))
        _close(out.numpy(), ref)
        for n in ("k", "v"):
            _close(tpool[n].numpy(), jpool[n])
        pos = pos + 1
