"""The port's decode attention (deeplearning4j_tpu_torch/ops/
decode_attention.py) and the attention layers' streaming methods,
against the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX layer methods
(``apply_stream_bounded``, ``apply_stream_paged``, ``apply_stream``) and
the port's, which attend through ``decode_attention`` (its plain version
on the CPU). Outputs and the caches / pools written in place are held to
atol=1e-5, rtol=1e-5: float32 on both sides, sums in another order. The
CUDA kernel itself runs only on a card: those tests carry the ``cuda``
marker and skip here.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.layers import (SelfAttentionLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.layers import attention as tattention
from deeplearning4j_tpu_torch.ops import decode_attention as tda
from deeplearning4j_tpu_torch.ops import native

ATOL, RTOL = 1e-5, 1e-5
D_MODEL, HEADS = 32, 4


def _layers(kind, seed=0):
    """A JAX layer with perturbed (non-zero bias) params, its port twin
    and the params as numpy and as tensors."""
    rng = np.random.default_rng(seed)
    if kind == "attn":
        jl = SelfAttentionLayer(n_in=D_MODEL, n_out=D_MODEL, n_heads=HEADS,
                                causal=True, qkv_bias=True)
    else:
        jl = TransformerEncoderLayer(n_in=D_MODEL, n_out=D_MODEL,
                                     n_heads=HEADS, causal=True)
    params, _ = jl.initialize(jax.random.PRNGKey(seed),
                              JaxInputType.recurrent(D_MODEL))
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
            np.float32), params)
    tl = tlayers.layer_from_dict(jl.to_dict())
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    return jl, tl, params, tparams


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


def _pools(rng, n, ps):
    Dh = D_MODEL // HEADS
    return {k: rng.normal(0, 1, (n, ps, HEADS, Dh)).astype(np.float32)
            for k in ("k", "v")}


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ------------------------------------------------------------ the layers

@pytest.mark.parametrize("kind", ["attn", "block"])
@pytest.mark.parametrize("pos,t", [(0, 5), (7, 1), (20, 4), (59, 5)])
def test_bounded_step_matches_jax(kind, pos, t):
    jl, tl, params, tparams = _layers(kind, pos + t)
    rng = np.random.default_rng(pos)
    cache = _pools(rng, 3, 64)
    x = rng.normal(0, 1, (3, t, D_MODEL)).astype(np.float32)
    ref, jcache = jl.apply_stream_bounded(params, cache, x, np.int32(pos))
    tcache = _tensors(cache)
    out, same = tl.apply_stream_bounded(tparams, tcache, torch.from_numpy(x),
                                        pos)
    assert same is tcache                       # written in place
    _close(out, ref)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])


@pytest.mark.parametrize("kind", ["attn", "block"])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_step_matches_jax(kind, t):
    jl, tl, params, tparams = _layers(kind, t)
    rng = np.random.default_rng(10 + t)
    ps, P = 8, 8
    pool = _pools(rng, 20, ps)
    # slot 0 mid page, slot 1 at a page boundary, slot 2 sharing slot 0's
    # first page read-only, slot 3 inactive (all-zero row at pos 0)
    table = np.zeros((4, P), np.int32)
    table[0, :4] = [3, 5, 7, 9]
    table[1, :5] = [2, 4, 6, 8, 10]
    table[2, :3] = [3, 11, 12]
    pos = np.array([13, 32, 8, 0], np.int32)
    x = rng.normal(0, 1, (4, t, D_MODEL)).astype(np.float32)
    ref, jpool = jl.apply_stream_paged(
        params, {k: jnp.asarray(v) for k, v in pool.items()}, table, pos, x)
    tpool = _tensors(pool)
    out, _ = tl.apply_stream_paged(tparams, tpool, torch.from_numpy(table),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(x))
    _close(out[:3], np.asarray(ref)[:3])        # slot 3's output is ignored
    for k in ("k", "v"):
        # the scratch page's row 0 takes the inactive slot's dummy write
        _close(tpool[k][1:], np.asarray(jpool[k])[1:])


@pytest.mark.parametrize("kind", ["attn", "block"])
def test_paged_step_with_index_once_matches_jax(kind):
    """The step's indices computed once (``paged_index``, what the paged
    session builds for all its layers) give the JAX layer's output and
    pool writes, over positions that cross page edges."""
    jl, tl, params, tparams = _layers(kind, 5)
    rng = np.random.default_rng(21)
    ps, P = 8, 4
    pool = _pools(rng, 12, ps)
    table = np.zeros((3, P), np.int32)
    table[0] = [3, 5, 7, 9]
    table[1] = [2, 4, 6, 8]
    pos = np.array([7, 8, 0], np.int32)      # last row of a page, first
    x = rng.normal(0, 1, (3, 1, D_MODEL)).astype(np.float32)
    ref, jpool = jl.apply_stream_paged(
        params, {k: jnp.asarray(v) for k, v in pool.items()}, table, pos, x)
    tpool = _tensors(pool)
    ttable = torch.from_numpy(table)
    idx = tattention.paged_index(ttable, torch.from_numpy(pos), 1, ps)
    assert idx.page.tolist() == [[3], [4], [0]]
    assert idx.offset.tolist() == [[7], [0], [0]]
    out, _ = tl.apply_stream_paged(tparams, tpool, ttable, idx,
                                   torch.from_numpy(x))
    _close(out[:2], np.asarray(ref)[:2])     # slot 2 is inactive
    for k in ("k", "v"):
        _close(tpool[k][1:], np.asarray(jpool[k])[1:])


def _lm_pair(tmp_path, seed=0):
    """A 2-layer causal LM (V=32, D=32, H=4) built and saved by the JAX
    package, and the port's restore of the zip."""
    from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                                   RnnOutputLayer)
    from deeplearning4j_tpu.util import model_serializer as jser
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    b = (NeuralNetConfiguration.builder().set_seed(seed).list()
         .layer(EmbeddingSequenceLayer(n_in=32, n_out=D_MODEL)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=HEADS, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=32, loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(32, 48)).build())
    jnet = JaxNet(conf).init()
    path = str(tmp_path / "lm.zip")
    jser.write_model(jnet, path)
    return jnet, restore_model(path, device="cpu")


def test_paged_session_step_matches_jax_across_pages(tmp_path):
    """The port's paged step (one staged block, the indices computed once
    for both layers) equals the JAX ``PagedSlotSession.step_slots`` step
    by step while three slots' positions cross 8-token pages, one slot
    idle between its streams."""
    jnet, net = _lm_pair(tmp_path)
    js, ts = (n.paged_slot_streaming_session(capacity=48, slots=3,
                                             page_size=8)
              for n in (jnet, net))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 32, n) for n in (19, 9, 13)]
    for s in (js, ts):
        for slot in (0, 1):
            s.bind(slot, s.reserve(prompts[slot], 4))
    active = np.array([True, True, False])
    for step in range(19):
        if step == 6:                 # slot 2 joins mid-way
            for s in (js, ts):
                s.bind(2, s.reserve(prompts[2], 4))
            active[2] = True
        x = np.zeros((3, 1, 1), np.float32)
        for slot in range(3):
            if active[slot]:
                x[slot, 0, 0] = prompts[slot][min(
                    int(ts.slot_pos[slot]), len(prompts[slot]) - 1)]
        ref = np.asarray(js.step_slots(x.copy(), active))
        out = ts.step_slots(x.copy(), active).numpy()
        _close(out[active], ref[active])
        np.testing.assert_array_equal(ts.slot_pos, js.slot_pos)
    assert int(ts.slot_pos.max()) > 16        # crossed two page edges


@pytest.mark.parametrize("kind", ["attn", "block"])
def test_eager_stream_matches_jax(kind):
    jl, tl, params, tparams = _layers(kind, 7)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 11, D_MODEL)).astype(np.float32)
    jc = tc = None
    for a, b in ((0, 4), (4, 5), (5, 11)):
        ref, jc = jl.apply_stream(params, jc, x[:, a:b])
        out, tc = tl.apply_stream(tparams, tc, torch.from_numpy(x[:, a:b]))
        _close(out, ref)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_stream_methods_refuse_non_causal():
    tl = tlayers.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2)
    with pytest.raises(ValueError, match="causal=True"):
        tl.apply_stream({}, None, torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="causal=True"):
        tl.apply_stream_paged({}, {}, None, [0], torch.zeros(1, 1, 8))


# ------------------------------------------------------------------ the op

def _op_inputs(seed, S, t, ps, P, D=8, H=2):
    rng = np.random.default_rng(seed)
    N = S * P + 1
    kp, vp = (torch.from_numpy(rng.normal(0, 1, (N, ps, H, D)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(0, 1, (S, t, H, D)).astype(np.float32))
    table = torch.from_numpy(
        (rng.permutation(N - 1)[:S * P] + 1).reshape(S, P).astype(np.int32))
    return q, kp, vp, table


def test_plain_is_the_masked_softmax_over_live_keys():
    """Key j of slot s at (table[s, j // ps], j % ps) for j <= pos + i,
    as a loop over slots, queries and heads."""
    q, kp, vp, table = _op_inputs(0, 3, 3, 4, 5)
    pos = np.array([0, 6, 17])
    o = tda.decode_attention_plain(q, kp, vp, table, pos)
    for s in range(3):
        for i in range(3):
            n = pos[s] + i + 1
            rows = [(int(table[s, j // 4]), j % 4) for j in range(n)]
            k = torch.stack([kp[p, r] for p, r in rows])      # (n, H, D)
            v = torch.stack([vp[p, r] for p, r in rows])
            w = torch.softmax(torch.einsum("hd,nhd->hn", q[s, i], k)
                              * 8 ** -0.5, dim=-1)
            ref = torch.einsum("hn,nhd->hd", w, v)
            torch.testing.assert_close(o[s, i], ref, atol=ATOL, rtol=RTOL)


def test_plain_takes_positions_as_a_cpu_tensor():
    """Positions as a CPU tensor (alone, or as the host copy beside
    them) give the host-position call's output."""
    q, kp, vp, table = _op_inputs(5, 3, 2, 4, 5)
    pos = [0, 7, 17]
    ref = tda.decode_attention_plain(q, kp, vp, table, pos)
    t = torch.tensor(pos, dtype=torch.int32)
    torch.testing.assert_close(
        tda.decode_attention_plain(q, kp, vp, table, t), ref, atol=0,
        rtol=0)
    torch.testing.assert_close(
        tda.decode_attention(q, kp, vp, table, t, host_pos=np.array(pos)),
        ref, atol=0, rtol=0)


def _split_merge(q, kp, vp, table, pos, chunk):
    """The kernel's split and merge in plain PyTorch: each slot's keys
    cut into fixed chunks of ``chunk``, each chunk's partial (m, l, o)
    with m = -inf and l = 0 where it holds no visible key, merged in
    chunk order by M = max m_k, o = sum_k o_k e^(m_k - M) / sum_k l_k
    e^(m_k - M), empty chunks skipped."""
    S, t, H, D = q.shape
    ps, P = kp.shape[1], table.shape[1]
    tl = table.long()
    k = kp[tl].reshape(S, P * ps, H, D)
    v = vp[tl].reshape(S, P * ps, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    q_pos = torch.as_tensor(pos)[:, None] + torch.arange(t)[None, :]
    visible = (torch.arange(P * ps)[None, None, :]
               <= q_pos[:, :, None])[:, None]              # (S, 1, t, K)
    parts = []
    for c0 in range(0, P * ps, chunk):
        lg = logits[..., c0:c0 + chunk]
        vis = visible[..., c0:c0 + chunk].expand_as(lg)
        m = torch.where(vis, lg, -math.inf).amax(-1)
        p = torch.where(vis, torch.exp(
            lg - torch.where(torch.isinf(m), 0.0, m)[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, c0:c0 + chunk])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l, o in parts:                      # chunk order, skip empty
        f = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
        den = den + l * f
        num = num + o * f[..., None]
    return (num / den[..., None]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("chunk", [tda.KEY_CHUNK, 24])
def test_split_merge_reference_equals_plain(D, t, chunk):
    """The kernel's split over fixed key chunks, each chunk's (m, l, o)
    merged in chunk order with empty chunks skipped, equals the plain
    softmax: positions at and across chunk edges (0, chunk - 1, chunk,
    chunk + 1), one past the first chunk's end by t, and an inactive
    slot (all-zero table row at position 0)."""
    rng = np.random.default_rng(D + t + chunk)
    S, H, ps, P = 5, 2, 64, 4                  # span 256: two chunks of 128
    N = S * P + 1
    kp, vp = (torch.from_numpy(rng.normal(0, 1, (N, ps, H, D)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(0, 1, (S, t, H, D)).astype(np.float32))
    table = torch.from_numpy((rng.permutation(N - 1)[:S * P] + 1)
                             .reshape(S, P).astype(np.int32))
    table[4] = 0                               # the inactive slot
    pos = [chunk - 1, chunk, chunk + 1 - t if chunk + 1 >= t else 0,
           ps * P - t, 0]
    o = _split_merge(q, kp, vp, table, pos, chunk)
    torch.testing.assert_close(
        o, tda.decode_attention_plain(q, kp, vp, table, pos), atol=ATOL,
        rtol=RTOL)
    assert tda.n_key_splits(ps * P) == 2


def test_dense_cache_is_one_page_per_row():
    """A dense cache through the op: page_size = capacity, table =
    arange(B)[:, None]; equal to gathering the same rows into pages."""
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.normal(0, 1, (2, 24, 2, 8)).astype(
        np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, 8)).astype(np.float32))
    dense = tda.decode_attention(q, cache, cache,
                                 torch.arange(2)[:, None].int(), [5, 21])
    paged = tda.decode_attention(q, cache.reshape(6, 8, 2, 8),
                                 cache.reshape(6, 8, 2, 8),
                                 torch.arange(6).reshape(2, 3).int(),
                                 np.array([5, 21]))
    torch.testing.assert_close(dense, paged)


def test_cpu_tensors_take_the_plain_version():
    q, kp, vp, table = _op_inputs(2, 2, 1, 4, 3)
    before = tda.decode_attention_cuda.launches
    out = tda.decode_attention(q, kp, vp, table, 5)
    assert tda.decode_attention_cuda.launches == before
    torch.testing.assert_close(
        out, tda.decode_attention_plain(q, kp, vp, table, [5, 5]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention_cuda(q, kp, vp, table, 5)


@pytest.mark.parametrize("bad", ["past_table", "negative", "shape",
                                 "dtype", "table_rows", "float_table",
                                 "pos_shape", "pos_float", "slots"])
def test_inputs_are_checked(bad):
    q, kp, vp, table = _op_inputs(3, 2, 2, 4, 3)
    pos = [0, 10]
    err = ValueError
    if bad == "past_table":
        pos = [0, 11]                 # 11 + t=2 > 3 pages x 4
    elif bad == "negative":
        pos = [-1, 0]
    elif bad == "shape":
        kp = kp[..., :4]
    elif bad == "dtype":
        q, err = q.double(), TypeError
    elif bad == "table_rows":
        table = table[:1]
    elif bad == "float_table":
        table, err = table.float(), TypeError
    elif bad == "pos_shape":
        pos = [0, 1, 2]
    elif bad == "slots":
        # no slot limit any more (positions are read from device memory,
        # not carried in the launch): the checks hold at any slot count
        q, table, pos = (q.repeat(257, 1, 1, 1), table.repeat(257, 1),
                         [0] * 513 + [11])
    else:
        pos, err = np.array([0.0, 1.0]), TypeError
    with pytest.raises(err):
        tda.decode_attention(q, kp, vp, table, pos)


def test_positions_are_host_data():
    assert tda.host_positions(3, 2).tolist() == [3, 3]
    assert tda.host_positions(np.array([1, 2]), 2).dtype == torch.int32
    meta = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="host"):
        tda.host_positions(meta, 2)
    # device positions need their host copy: the checks never read the
    # device
    q, kp, vp, table = _op_inputs(3, 2, 1, 4, 3)
    with pytest.raises(ValueError, match="host copy"):
        tda.decode_attention(q, kp, vp, table, meta)


def test_kernel_source_and_entry():
    path = os.path.join(native.CSRC_DIR, "decode_attention.cu")
    with open(path) as f:
        src = f.read()
    assert 'extern "C" int dl4j_decode_attention_f32(' in src
    assert "apply_stream_paged" in src          # what it replaces
    assert "bound" in src.lower()


# ------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the chip smoke's decode-kernel cases, at H=4: (S, t, page_size, P, pos)
_CARD_CASES = [
    (8, 1, 16, 64, [0, 1, 15, 16, 17, 511, 1023, 0]),   # last one inactive
    (2, 4, 16, 64, [300, 0]),
    (2, 128, 16, 64, [0, 300]),
    (2, 5, 16, 3, [40, 43]),          # P * page_size not a tile multiple
    (3, 1, 1024, 1, [1023, 5, 0]),    # dense: page_size = capacity
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("case", range(len(_CARD_CASES)))
def test_kernel_matches_plain_on_card(cuda_device, D, case):
    S, t, ps, P, pos = _CARD_CASES[case]
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        case, S, t, ps, P, D=D, H=4))
    if ps == 1024:
        table = torch.arange(S, dtype=torch.int32,
                             device=cuda_device)[:, None]
    if case == 0:
        table[7] = 0                  # the inactive slot reads scratch
    before = tda.decode_attention_cuda.launches
    o = tda.decode_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    assert tda.decode_attention_cuda.launches == before + 1
    ref = tda.decode_attention_plain(q, kp, vp, table, pos)
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=2e-4)


@pytest.mark.cuda
def test_kernel_shared_prefix_page_on_card(cuda_device):
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        9, 2, 1, 16, 4, D=64, H=4))
    table[1, 0] = table[0, 0]         # both slots read one prefix page
    o = tda.decode_attention(q, kp, vp, table, [20, 33])
    torch.testing.assert_close(
        o, tda.decode_attention_plain(q, kp, vp, table, [20, 33]),
        atol=2e-5, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 192, 256])
def test_kernel_refuses_device_positions_and_odd_head_dim(cuda_device, D):
    """Device positions without their host copy are refused (the checks
    read the host copy only). A head dim past 128, refused until the
    kernel's wide launch came, gives the plain version's output."""
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        4, 2, 1, 4, 3, D=D, H=2))
    torch.testing.assert_close(
        tda.decode_attention(q, kp, vp, table, [0, 1]),
        tda.decode_attention_plain(q, kp, vp, table, [0, 1]),
        atol=2e-5, rtol=2e-4)
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        4, 2, 1, 4, 3, D=48, H=2))
    with pytest.raises(ValueError, match="host"):
        tda.decode_attention(q, kp, vp, table,
                             torch.zeros(2, dtype=torch.int32,
                                         device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 8, 16, 48, 96, 160, 192])
@pytest.mark.parametrize("case", range(len(_CARD_CASES)))
def test_padded_head_dims_match_plain_on_card(cuda_device, D, case):
    """A head dim the kernel is not built for: the pools the sessions
    allocate (``zero_kv_pool``, read in place at the padded width) and a
    contiguous pool (padded by a copy) both give the plain version's
    output at D, in one launch each."""
    S, t, ps, P, pos = _CARD_CASES[case]
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        case, S, t, ps, P, D=D, H=4))
    if ps == 1024:
        table = torch.arange(S, dtype=torch.int32,
                             device=cuda_device)[:, None]
    if case == 0:
        table[7] = 0
    ref = tda.decode_attention_plain(q, kp, vp, table, pos)
    pk, pv = (tda.zero_kv_pool(*kp.shape, device=cuda_device)
              for _ in range(2))
    pk.copy_(kp)
    pv.copy_(vp)
    assert pk.stride(2) > D
    before = tda.decode_attention_cuda.launches
    for pools in ((pk, pv), (kp, vp)):
        o = tda.decode_attention(q, *pools, table, pos)
        torch.cuda.synchronize()
        assert o.shape == q.shape
        torch.testing.assert_close(o, ref, atol=2e-5, rtol=2e-4)
    assert tda.decode_attention_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("t", [1, 16])
def test_kernel_device_positions_at_chunk_edges_on_card(cuda_device, D, t):
    """Positions read from device memory, at and across the split
    kernel's chunk edges (KEY_CHUNK keys a CTA) and page edges, with an
    inactive slot; equal to the plain version within the card tolerance,
    and two launches on the same inputs give the same bits."""
    c = tda.KEY_CHUNK
    pos = [0, 15, 16, c - 1, c, 511, 1024 - t, 0]
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        20 + D + t, 8, t, 16, 64, D=D, H=4))
    table[7] = 0                      # the inactive slot reads scratch
    host = np.array(pos, np.int32)
    dev = torch.from_numpy(host).to(cuda_device)
    o = tda.decode_attention(q, kp, vp, table, dev, host_pos=host)
    again = tda.decode_attention(q, kp, vp, table, dev, host_pos=host)
    torch.cuda.synchronize()
    assert torch.equal(o, again)
    torch.testing.assert_close(
        o, tda.decode_attention_plain(q, kp, vp, table, pos), atol=2e-5,
        rtol=2e-4)


@pytest.mark.cuda
def test_kernel_takes_a_misaligned_q_view_on_card(cuda_device):
    """A contiguous q view at an offset that is not a multiple of 16
    bytes: the wrapper copies it rather than fault on a 16-byte load."""
    q, kp, vp, table = (x.to(cuda_device) for x in _op_inputs(
        10, 2, 1, 16, 4, D=64, H=4))
    buf = torch.empty(q.numel() + 1, device=cuda_device)
    view = buf[1:].view(q.shape)
    view.copy_(q)
    assert view.is_contiguous() and view.data_ptr() % 16
    o = tda.decode_attention(view, kp, vp, table, [20, 33])
    torch.cuda.synchronize()
    torch.testing.assert_close(
        o, tda.decode_attention_plain(q, kp, vp, table, [20, 33]),
        atol=2e-5, rtol=2e-4)


def test_launch_counters_lose_nothing_across_threads():
    """Eight threads count launches at once, as three replicas' worker
    threads do in one process: every increment lands."""
    import threading
    from deeplearning4j_tpu_torch.ops import attention as tattn
    wrappers = (tda.decode_attention_cuda, tattn.flash_attention_fwd_cuda,
                tattn.flash_attention_bwd_dq_cuda,
                tattn.flash_attention_bwd_dkv_cuda)
    saved = [w.launches for w in wrappers]
    barrier = threading.Barrier(8)

    def count():
        barrier.wait()
        for _ in range(20000):
            for w in wrappers:
                native.count_launch(w)

    try:
        for w in wrappers:
            w.launches = 0
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert [w.launches for w in wrappers] == [8 * 20000] * 4
    finally:
        for w, n in zip(wrappers, saved):
            w.launches = n
