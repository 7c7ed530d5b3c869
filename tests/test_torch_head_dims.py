"""Head dims the attention kernels are not instantiated for.

The port's kernels are built at D = 32, 64 and 128; any other D up to
128 runs at the next of those, its operands zero-padded along D, with
the scale of the true D (``ops/native.kernel_head_dim``,
``ops/attention.py``, ``ops/decode_attention.py``). The CUDA launches
themselves run on the card (``-m cuda`` in ``test_torch_attention.py``
and ``test_torch_decode.py``); here the padding's arithmetic is held on
the CPU: the plain versions on zero-padded (B, T, H, Dp) operands at the
true D's scale, sliced back, against the plain versions unpadded (within
1e-6), the decode pools' padded layout, and an LM at head dims 4, 8 and
16 against the JAX package (output, one Adam step, greedy ids of a paged
batcher).
"""

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
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.serving import ContinuousBatcher as JaxBatcher
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import decode_attention as tda
from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.serving.continuous import ContinuousBatcher
from deeplearning4j_tpu_torch.util import model_serializer as tser

PAD_DIMS = [4, 8, 16, 24, 48, 96]
TOL = 1e-6


def test_kernel_head_dim_rounds_up_and_refuses_past_128():
    assert [native.kernel_head_dim(d) for d in (1, 4, 8, 16, 24, 32, 33,
                                                48, 64, 65, 96, 128)] \
        == [32, 32, 32, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="limit of 128.*JAX package"):
        native.kernel_head_dim(160)


def _qkv(D, seed, B=2, T=37, H=3, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (B, T, H, D))
                                    .astype(np.float32)) for _ in range(4))
    mask = None
    if masked:
        m = np.ones((B, T), np.float32)
        m[0, T // 2:] = 0
        mask = torch.from_numpy(m)
    return q, k, v, do, mask


@pytest.mark.parametrize("D", PAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_padded_forward_and_backward_equal_unpadded(D, causal):
    """What a padded launch computes: the plain versions on operands
    zero-padded to the kernel's width, at the true D's scale, sliced
    back to D, equal the plain versions on the unpadded operands."""
    q, k, v, do, mask = _qkv(D, seed=D + causal)
    Dp = native.kernel_head_dim(D)
    scale = 1.0 / np.sqrt(D)
    qp, kp, vp, dop = (tattn.pad_head_dim(t, Dp) for t in (q, k, v, do))
    assert qp.shape[-1] == Dp and qp.is_contiguous()
    assert torch.equal(qp[..., D:], torch.zeros_like(qp[..., D:]))

    o, lse = tattn.flash_attention_fwd_plain(q, k, v, mask, causal=causal)
    op, lsep = tattn.flash_attention_fwd_plain(qp, kp, vp, mask,
                                               causal=causal, scale=scale)
    np.testing.assert_allclose(op[..., :D], o, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lsep, lse, atol=TOL, rtol=TOL)
    assert torch.all(op[..., D:] == 0)

    dq, delta = tattn.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                   mask, causal=causal)
    dk, dv = tattn.flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                                 mask, causal=causal)
    o_p = tattn.pad_head_dim(o, Dp)
    dqp, deltap = tattn.flash_attention_bwd_dq_plain(
        qp, kp, vp, o_p, lse, dop, mask, causal=causal, scale=scale)
    dkp, dvp = tattn.flash_attention_bwd_dkv_plain(
        qp, kp, vp, lse, deltap, dop, mask, causal=causal, scale=scale)
    np.testing.assert_allclose(deltap, delta, atol=TOL, rtol=TOL)
    for got, want in ((dqp, dq), (dkp, dk), (dvp, dv)):
        np.testing.assert_allclose(got[..., :D], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", PAD_DIMS)
def test_padded_pool_decode_equals_unpadded(D):
    """The sessions' pools at a padded width (``zero_kv_pool`` as on the
    card): the Dh-wide view of a zeroed (N, ps, H, Dp) buffer. Written
    through the view, the buffer's padding stays zero; the plain decode
    over the whole padded buffer with q zero-padded and the true scale,
    sliced, equals the plain decode over the view. On the CPU a pool is
    unpadded."""
    rng = np.random.default_rng(D)
    N, ps, H, S, t = 9, 4, 2, 2, 3
    Dp = native.kernel_head_dim(D)
    assert tda.zero_kv_pool(N, ps, H, D).is_contiguous()
    kp, vp = (tda.zero_kv_pool(N, ps, H, D, padded=True) for _ in range(2))
    assert kp.shape == (N, ps, H, D)
    assert kp.stride() == (ps * H * Dp, H * Dp, Dp, 1)
    for p in (kp, vp):
        p.copy_(torch.from_numpy(rng.normal(0, 1, (N, ps, H, D))
                                 .astype(np.float32)))
    kbuf, vbuf = (p.as_strided((N, ps, H, Dp), p.stride()) for p in (kp, vp))
    assert torch.all(kbuf[..., D:] == 0) and torch.all(vbuf[..., D:] == 0)
    q = torch.from_numpy(rng.normal(0, 1, (S, t, H, D)).astype(np.float32))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    pos = [2, 7]
    o = tda.decode_attention_plain(q, kp, vp, table, pos)
    op = tda.decode_attention_plain(tattn.pad_head_dim(q, Dp), kbuf, vbuf,
                                    table, pos, scale=D ** -0.5)
    np.testing.assert_allclose(op[..., :D], o, atol=TOL, rtol=TOL)
    dense = torch.from_numpy(rng.normal(0, 1, (N, ps, H, D))
                             .astype(np.float32))
    assert tda._kernel_pool(dense, Dp).shape == (N, ps, H, Dp)
    assert tda._kernel_pool(kp, Dp).data_ptr() == kp.data_ptr()


def test_head_dim_past_128_keeps_a_plain_pool_on_the_cpu():
    for padded in (None, True):
        p = tda.zero_kv_pool(2, 4, 1, 160, padded=padded)
        assert p.shape == (2, 4, 1, 160) and p.is_contiguous()


# ------------------------------------------ LMs at small head dims vs JAX

V, T, B, CAP, PS = 32, 12, 2, 32, 4
LR = 1e-3


def _jax_lm(width, heads):
    conf = (NeuralNetConfiguration.builder().set_seed(3)
            .updater(jupd.adam(LR)).list()
            .layer(EmbeddingSequenceLayer(n_in=V, n_out=width))
            .layer(TransformerEncoderLayer(n_heads=heads, causal=True))
            .layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return JaxNet(conf).init()


def _run(cb, prompts, n):
    try:
        hs = [cb.submit(p, n) for p in prompts]
        return [np.asarray(cb.wait(h)) for h in hs]
    finally:
        assert cb.shutdown(drain=True)


@pytest.mark.parametrize("width,heads", [(8, 2), (16, 2), (32, 2)],
                         ids=["dh4", "dh8", "dh16"])
def test_lm_at_small_head_dim_matches_jax(tmp_path, monkeypatch, width,
                                         heads):
    jn = _jax_lm(width, heads)
    path = str(tmp_path / "lm.zip")
    jser.write_model(jn, path)
    tn = tser.restore_model(path, device="cpu")
    Dh = width // heads
    assert tn.layers[1].zero_page_pool(3, PS)["k"].is_contiguous()
    # the sessions' pools padded to the kernel's width, as on the card:
    # the batcher below writes, reads and copies pages through the views
    unpadded = tda.zero_kv_pool
    monkeypatch.setattr(tda, "zero_kv_pool",
                        lambda *a, **kw: unpadded(*a, **kw, padded=True))
    pool = tn.layers[1].zero_page_pool(3, PS)
    assert pool["k"].shape[-1] == Dh
    assert pool["k"].stride(2) == native.kernel_head_dim(Dh)

    rng = np.random.default_rng(width)
    ids = rng.integers(0, V, (B, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    np.testing.assert_allclose(tn.output(ids[..., None]).numpy(),
                               np.asarray(jn.output(ids[..., None])),
                               atol=2e-6, rtol=2e-4)
    jn.fit(JaxDataSet(ids, y))
    tn.fit(DataSet(ids, y))
    np.testing.assert_allclose(float(tn.score_value), float(jn.score_value),
                               atol=2e-6, rtol=2e-4)
    flat_j = {k: np.asarray(v) for k, v in
              jser._flatten_with_paths(jn.params).items()}
    flat_t = tser._flatten(tn.params)
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], atol=LR / 20,
                                   rtol=2e-4, err_msg=k)

    prompts = [rng.integers(1, V, (m,)) for m in (5, 3, 9)]
    ref = _run(JaxBatcher(jn, slots=2, capacity=CAP, kv_mode="paged",
                          page_size=PS, name="jax"), prompts, 6)
    got = _run(ContinuousBatcher(tn, slots=2, capacity=CAP,
                                 kv_mode="paged", page_size=PS,
                                 name="port"), prompts, 6)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
