"""The port's flash attention, forward and backward (deeplearning4j_tpu_
torch/ops/attention.py), against the JAX package's.

On the CPU the port's wrappers take their plain versions; they are held
against the Pallas kernels in interpret mode (as
tests/test_native_and_kernels.py runs them), against the JAX dispatch
(blockwise / exact masked attention on the CPU), against ``_exact_masked``
and against ``jax.vjp`` of it. The CUDA kernels themselves run only on a
card: those tests carry the ``cuda`` marker and skip here.

Tolerance: float32 on both sides, sums in another order, so
atol=2e-5, rtol=2e-4 (o values are O(1), lse values O(log T)).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import native

ATOL, RTOL = 2e-5, 2e-4


def _inputs(seed, B, T, H, D, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, T // 2:] = 0          # tail padding
        mask[1, :] = 0                # a row that sees no key
    return q, k, v, mask


def _port(q, k, v, mask, causal, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal, **kw)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("T", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret(T, masked, causal):
    q, k, v, mask = _inputs(T + 2 * masked + causal, 2, T, 2, 8, masked)
    jo, jlse = jattn.pallas_flash_attention(
        q, k, v, mask, causal=causal, block_q=16, block_k=16,
        interpret=True, precision="highest", return_lse=True)
    o, lse = _port(q, k, v, mask, causal)
    np.testing.assert_allclose(o, np.asarray(jo), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=ATOL,
                               rtol=RTOL)
    if masked:
        assert np.all(o[1] == 0) and np.all(lse[1] == -1e30)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_public_entry_matches_jax_dispatch(masked, causal):
    q, k, v, mask = _inputs(7, 2, 48, 4, 16, masked)
    ref = np.asarray(jattn.flash_attention(q, k, v, causal=causal,
                                           kv_mask=mask))
    out = tattn.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_plain_matches_exact_masked():
    T = 17                            # ragged: no block divides it
    q, k, v, mask = _inputs(T, 3, T, 2, 8, True)
    mask[2, ::3] = 0
    ref = np.asarray(jattn._exact_masked(q, k, v, mask, True))
    o, _ = _port(q, k, v, mask, True)
    np.testing.assert_allclose(o, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32,
                                   torch.float32])
def test_mask_dtypes_agree(dtype):
    q, k, v, mask = _inputs(3, 2, 16, 2, 8, True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    ref = tattn.flash_attention(*t, kv_mask=torch.from_numpy(mask))
    out = tattn.flash_attention(*t, kv_mask=torch.from_numpy(mask)
                                .to(dtype))
    assert torch.equal(out, ref)


def test_return_lse_false_gives_o_only():
    q, k, v, _ = _inputs(4, 1, 8, 1, 8, False)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o = tattn.flash_attention_fwd(*t, causal=True, return_lse=False)
    assert isinstance(o, torch.Tensor) and o.shape == (1, 8, 1, 8)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, _ = _inputs(5, 1, 16, 2, 32, False)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = tattn.flash_attention_fwd_cuda.launches
    o, lse = tattn.flash_attention_fwd(*t, causal=True)
    po, plse = tattn.flash_attention_fwd_plain(*t, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert tattn.flash_attention_fwd_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, _ = _inputs(6, 1, 8, 1, 32, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_fwd_cuda(
            *(torch.from_numpy(a) for a in (q, k, v)))


@pytest.mark.parametrize("bad", ["dtype", "shape", "precision", "mask"])
def test_inputs_are_checked(bad):
    q, k, v, mask = _inputs(8, 2, 8, 1, 8, True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = torch.from_numpy(mask)
    kw = {}
    if bad == "dtype":
        t[0] = t[0].double()
        err = TypeError
    elif bad == "shape":
        t[1] = t[1][:, :4]
        err = ValueError
    elif bad == "precision":
        kw["precision"] = "bf16"
        err = ValueError
    else:
        m = m[:, :4]
        err = ValueError
    with pytest.raises(err):
        tattn.flash_attention_fwd(*t, m, **kw)


def test_kernel_build_is_from_repo_sources(monkeypatch, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(os.path.join(native.CSRC_DIR,
                                       "flash_attention_fwd.cu"))
    assert native.BUILD_DIR == os.path.join(repo, "build", "kernels")
    assert "sm_90a" in " ".join(native.NVCC_FLAGS)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()
    # no nvcc: the build raises and says why, it does not fall back
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        native._nvcc()


def test_kernel_build_key_covers_shared_headers(monkeypatch, tmp_path):
    # an edited csrc/*.cuh must not leave a stale library in build/kernels
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(native, "CSRC_DIR", str(tmp_path))
    first = native._target("k")
    assert os.path.dirname(first) == native.BUILD_DIR
    assert native._target("k") == first            # stable while unedited
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = native._target("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert native._target("k") not in (first, second)


def test_backward_kernels_include_the_shared_header():
    with open(os.path.join(native.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        assert '#include "tf32_mma.cuh"' in f.read()
    with open(os.path.join(native.CSRC_DIR, "tf32_mma.cuh")) as f:
        header = f.read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "+ 0x1000u) & 0xffffe000u" in header   # hi: _tf32 above


# ------------------------------------------------------------- backward

def _bwd_inputs(seed, B, T, H, D, masked):
    q, k, v, mask = _inputs(seed, B, T, H, D, masked)
    do = np.random.default_rng(seed + 100).normal(
        0, 1, (B, T, H, D)).astype(np.float32)
    if masked:
        do = do * mask[:, :, None, None]    # padded query rows: no grad
    return q, k, v, do, mask


def _port_bwd(q, k, v, o, lse, do, mask, causal):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)]
    m = None if mask is None else torch.from_numpy(mask)
    return [g.numpy() for g in
            tattn.flash_attention_bwd(*t, m, causal=causal)]


@pytest.mark.parametrize("T", [32, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_interpret(T, masked, causal):
    q, k, v, do, mask = _bwd_inputs(T + 2 * masked + causal, 2, T, 2, 8,
                                    masked)
    o, lse = jattn.pallas_flash_attention(
        q, k, v, mask, causal=causal, block_q=16, block_k=16,
        interpret=True, precision="highest", return_lse=True)
    ref = jattn.pallas_flash_attention_bwd(
        q, k, v, o, lse, do, mask, causal=causal, block_q=16, block_k=16,
        interpret=True, precision="highest")
    out = _port_bwd(q, k, v, o, lse, do, mask, causal)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    if masked:
        assert np.all(out[0][1] == 0)         # the row that saw no key


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_vjp_of_exact_masked(masked, causal):
    T = 17                            # ragged: no block divides it
    q, k, v, do, mask = _bwd_inputs(31 + causal, 3, T, 2, 8, True)
    if not masked:
        mask = np.ones_like(mask)
    else:
        mask[2, ::3] = 0
    o, lse = _port(q, k, v, mask, causal)
    _, vjp = jax.vjp(lambda a, b, c: jattn._exact_masked(a, b, c, mask,
                                                         causal), q, k, v)
    ref = vjp(do)
    out = _port_bwd(q, k, v, o, lse, do, mask, causal)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    if masked:
        assert np.all(out[0][1] == 0)         # the row that saw no key


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_of_plain(masked, causal):
    q, k, v, do, mask = _bwd_inputs(41, 2, 24, 3, 16, masked)
    m = None if mask is None else torch.from_numpy(mask)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tattn.flash_attention(*t, causal=causal, kv_mask=m)
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    t2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o2, _ = tattn.flash_attention_fwd_plain(*t2, m, causal=causal)
    want = torch.autograd.grad(o2, t2, torch.from_numpy(do))
    assert torch.equal(o.detach(), o2.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_mask_gets_no_gradient_and_inference_is_forward_only():
    q, k, v, _, mask = _bwd_inputs(5, 2, 16, 2, 8, True)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    m = torch.from_numpy(mask).requires_grad_()
    o = tattn.flash_attention(*t, causal=True, kv_mask=m)
    assert o.grad_fn is not None
    gm, = torch.autograd.grad(o.sum(), [m], allow_unused=True)
    assert gm is None                  # the mask is data
    with torch.inference_mode():
        o_inf = tattn.flash_attention(*t, causal=True, kv_mask=m)
    assert o_inf.grad_fn is None
    assert torch.equal(o_inf, o.detach())


def test_bwd_cpu_tensors_take_the_plain_version():
    q, k, v, do, _ = _bwd_inputs(6, 1, 16, 2, 32, False)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = tattn.flash_attention_fwd(*t, causal=True)
    before = (tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    got = tattn.flash_attention_bwd(*t, o, lse, torch.from_numpy(do),
                                    causal=True)
    want = tattn.flash_attention_bwd_plain(*t, o, lse, torch.from_numpy(do),
                                           causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (tattn.flash_attention_bwd_dq_cuda.launches,
                      tattn.flash_attention_bwd_dkv_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_bwd_dq_cuda(*t, o, lse, torch.from_numpy(do))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_attention_bwd_dkv_cuda(*t, lse, lse,
                                           torch.from_numpy(do))


@pytest.mark.parametrize("bad", ["o", "lse", "do_dtype"])
def test_bwd_inputs_are_checked(bad):
    q, k, v, do, _ = _bwd_inputs(7, 2, 8, 1, 8, False)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = tattn.flash_attention_fwd(*t)
    g = torch.from_numpy(do)
    err = ValueError
    if bad == "o":
        o = o[:, :4]
    elif bad == "lse":
        lse = lse[..., :4]
    else:
        g, err = g.double(), TypeError
    with pytest.raises(err):
        tattn.flash_attention_bwd(*t, o, lse, g)


# ------------------------------------------- 3xTF32: the kernels' arithmetic
#
# The kernels run every product on the tensor cores as three TF32 passes
# (csrc/tf32_mma.cuh). These tests emulate that arithmetic in float32 on
# the CPU and hold it to the same tolerance the card is held to; one pass
# is shown to miss it.

def _tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds, and as the
    kernels round an operand's hi part: to nearest, ties away from zero,
    the low 13 mantissa bits dropped."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """float32 -> TF32 as the tensor core reads an unrounded operand (the
    kernels' lo part): the low 13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(eq, a, b, passes):
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _bwd_tf32(q, k, v, o, lse, do, kv_mask, causal, passes):
    """The kernels' backward with its five products in ``passes`` TF32
    passes; exp, the masks, delta and p (dp - delta) scale in f32."""
    T, D = q.shape[1], q.shape[3]
    scale = 1.0 / np.sqrt(D)

    def mm(eq, a, b):
        return _mm_tf32(eq, a, b, passes)
    s = mm("bqhd,bkhd->bhqk", q, k)
    live = torch.ones((1, 1, T, T), dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    live = live & (lse > -1e30 / 2)[..., None]
    p = torch.where(live, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    delta = (do * o).sum(-1).permute(0, 2, 1)
    ds = p * (mm("bqhd,bkhd->bhqk", do, v) - delta[..., None]) * scale
    return (mm("bhqk,bkhd->bqhd", ds, k), mm("bhqk,bqhd->bkhd", ds, q),
            mm("bhqk,bqhd->bkhd", p, do))


def test_tf32_rounding_emulation():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -10, one + 2 ** -11, one + 2 ** -12,
                      -(one + 2 ** -11), one + 3 * 2 ** -11, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, one + 2 ** -10, one,
                         -(one + 2 ** -10), one + 2 * 2 ** -10, 0.0],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)   # ties go away from zero
    y = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 4096).astype(np.float32))
    hi = _tf32(y)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2 ** -11
    lo = _tf32_truncated(y - hi)
    assert torch.all(lo.abs() <= (y - hi).abs())      # toward zero
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2 ** -21


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_passes_meet_the_f32_tolerance(causal, masked):
    q, k, v, do, mask = _bwd_inputs(60 + 2 * causal + masked, 2, 128, 2,
                                    64, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    g = torch.from_numpy(do)
    m = None if mask is None else torch.from_numpy(mask)
    o, lse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    want = tattn.flash_attention_bwd_plain(*t, o, lse, g, m, causal=causal)
    three = _bwd_tf32(*t, o, lse, g, m, causal, passes=3)
    for got, ref in zip(three, want):
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    one = _bwd_tf32(*t, o, lse, g, m, causal, passes=1)
    for name, got, ref in zip(("dq", "dk", "dv"), one, want):
        assert not torch.allclose(got, ref, atol=ATOL, rtol=RTOL), name


def _fwd_tf32(q, k, v, kv_mask, causal, passes):
    """The forward kernel's arithmetic with its two products in
    ``passes`` TF32 passes: q scaled by scale * log2(e) before its split,
    s = q.k^T in base 2, the masks, max and exp2 in f32, then p (the
    probabilities, unnormalized) as an operand of p.v."""
    T, D = q.shape[1], q.shape[3]
    s = _mm_tf32("bqhd,bkhd->bhqk", q * (np.log2(np.e) / np.sqrt(D)), k,
                 passes)
    live = torch.ones((1, 1, T, T), dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    s = s.masked_fill(~live, -1e30)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m <= -1e30 / 2, torch.zeros(()), m)
    p = torch.exp2(s - m)
    l = p.sum(-1)
    o = _mm_tf32("bhqk,bkhd->bqhd", p, v, passes)
    o = o / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    lse = torch.where(l > 0, m[..., 0] * np.log(2) + torch.log(l),
                      torch.full((), -1e30))
    return o, lse


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_three_tf32_passes_meet_the_f32_tolerance(causal, masked):
    q, k, v, mask = _inputs(70 + 2 * causal + masked, 2, 128, 2, 64, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    want_o, want_lse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    o, lse = _fwd_tf32(*t, m, causal, passes=3)
    torch.testing.assert_close(o, want_o, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=RTOL)
    if masked:                        # the row that saw no key
        assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)
    one, _ = _fwd_tf32(*t, m, causal, passes=1)
    assert not torch.allclose(one, want_o, atol=ATOL, rtol=RTOL)


def _bwd_pair_tf32(q, k, v, o, lse, do, kv_mask, causal, passes, R=16):
    """The pair kernels' backward at D = 256 (csrc/flash_attention_bwd.cu):
    s and dp each the f32 sum of two 128-column products (one a
    warpgroup), dq summed over tiles of R keys into tile partials added
    in f32, dk and dv in one sum; products in ``passes`` TF32 passes."""
    T, D = q.shape[1], q.shape[3]
    C, scale = D // 2, 1.0 / np.sqrt(D)

    def mm(eq, a, b):
        return _mm_tf32(eq, a, b, passes)

    def halves(a, b):
        return (mm("bqhd,bkhd->bhqk", a[..., :C], b[..., :C])
                + mm("bqhd,bkhd->bhqk", a[..., C:], b[..., C:]))
    s = halves(q, k)
    live = torch.ones((1, 1, T, T), dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    live = live & (lse > -1e30 / 2)[..., None]
    p = torch.where(live, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    delta = (do * o).sum(-1).permute(0, 2, 1)
    ds = p * (halves(do, v) - delta[..., None]) * scale
    dq = sum(mm("bhqk,bkhd->bqhd", ds[..., j:j + R], k[:, j:j + R])
             for j in range(0, T, R))
    return (dq, mm("bhqk,bqhd->bkhd", ds, q),
            mm("bhqk,bqhd->bkhd", p, do))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_pair_kernels_sums_meet_the_f32_tolerance(causal, masked):
    """At D = 256 the pair kernels split s's and dp's sums over two
    warpgroups' 128 columns and add them in f32: in three TF32 passes
    that meets the tolerance the card is held to, in one it does not."""
    q, k, v, do, mask = _bwd_inputs(80 + 2 * causal + masked, 2, 48, 2,
                                    256, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    g = torch.from_numpy(do)
    m = None if mask is None else torch.from_numpy(mask)
    o, lse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    want = tattn.flash_attention_bwd_plain(*t, o, lse, g, m, causal=causal)
    three = _bwd_pair_tf32(*t, o, lse, g, m, causal, passes=3)
    for got, ref in zip(three, want):
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    if masked:                        # the row that saw no key
        assert torch.all(three[0][1] == 0)
    one = _bwd_pair_tf32(*t, o, lse, g, m, causal, passes=1)
    for name, got, ref in zip(("dq", "dk", "dv"), one, want):
        assert not torch.allclose(got, ref, atol=ATOL, rtol=RTOL), name


def _fwd_pair_tf32(q, k, v, kv_mask, causal, passes, R=32):
    """The pair forward's arithmetic at 128 < D <= 256
    (csrc/flash_attention_fwd.cu, flash_fwd_pair_kernel): q scaled by
    scale * log2(e) before its split, s in base 2 as the f32 sum of two
    products, one a warpgroup: the first half of the 8-column groups
    below D rounded up to a block of 4 (columns [0, 128) at D = 256,
    [0, 96) at 160) and the rest; the masks, then the key loop in tiles
    of R: the running max, exp2, and p.v of the tile into a partial
    added to acc * corr; products in ``passes`` TF32 passes."""
    T, D = q.shape[1], q.shape[3]
    qs = q * (np.log2(np.e) / np.sqrt(D))
    c = 8 * ((-(-D // 8) + 7) // 8 * 4)      # warpgroup 1's first column
    s = (_mm_tf32("bqhd,bkhd->bhqk", qs[..., :c], k[..., :c], passes)
         + _mm_tf32("bqhd,bkhd->bhqk", qs[..., c:], k[..., c:], passes))
    live = torch.ones((1, 1, T, T), dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    s = s.masked_fill(~live, -1e30)
    B, H = q.shape[0], q.shape[2]
    m = torch.full((B, H, T, 1), -1e30)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    for k0 in range(0, T, R):
        st = s[..., k0:k0 + R]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_sub = torch.where(m_new <= -1e30 / 2, torch.zeros(()), m_new)
        corr = torch.exp2(m - m_sub)
        p = torch.exp2(st - m_sub)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm_tf32("bhqk,bkhd->bhqd", p,
                                    v[:, k0:k0 + R], passes)
        m = m_new
    o = (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m * np.log(2) + torch.log(l.clamp_min(1e-30)),
                      torch.full((), -1e30))[..., 0]
    return o, lse


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_pair_forward_sums_meet_the_f32_tolerance(D, causal, masked):
    """At 128 < D <= 256 the pair forward splits s's sum over two
    warpgroups' columns and adds the halves in f32, and sums p.v in
    32-key tile partials: in three TF32 passes that meets the tolerance
    the card is held to, in one it does not."""
    q, k, v, mask = _inputs(90 + D + 2 * causal + masked, 2, 40, 2, D,
                            masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    want_o, want_lse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    o, lse = _fwd_pair_tf32(*t, m, causal, passes=3)
    torch.testing.assert_close(o, want_o, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=RTOL)
    if masked:                        # the row that saw no key
        assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)
    one, _ = _fwd_pair_tf32(*t, m, causal, passes=1)
    assert not torch.allclose(one, want_o, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D,in_place", [(160, True), (192, True),
                                        (256, True), (132, True),
                                        (130, False), (384, False),
                                        (128, False), (64, False)])
def test_forward_width_rule(D, in_place):
    """The forward reads 128 < D <= 256 with D % 4 == 0 as it is; 130
    (rows not 16-byte aligned) is padded to 256, 384 runs the chunked
    kernel, and the narrow widths are the kernels' own."""
    assert native.forward_reads_in_place(D) is in_place
    assert native.PAIR_DIM == 256
    if D == 130:
        assert native.kernel_head_dim(D) == 256


def test_c_fragment_feeds_the_next_product_as_a():
    """tf32_mma.cuh's as_a / load_b_pairs, lane by lane in numpy: with
    A = (c0, c2, c1, c3) and B's depth rows (2t, 2t + 1), the m16n8k8
    product of a C tile with M equals C . M."""
    rng = np.random.default_rng(3)
    c_tile = rng.normal(0, 1, (16, 8))
    m = rng.normal(0, 1, (8, 8))
    a_mat, b_mat = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = (c_tile[g, 2 * t], c_tile[g, 2 * t + 1],
             c_tile[g + 8, 2 * t], c_tile[g + 8, 2 * t + 1])
        a = (c[0], c[2], c[1], c[3])                    # as_a
        b = (m[2 * t, g], m[2 * t + 1, g])              # load_b_pairs
        # where the PTX layouts put each register of the lane
        a_mat[g, t], a_mat[g + 8, t] = a[0], a[1]
        a_mat[g, t + 4], a_mat[g + 8, t + 4] = a[2], a[3]
        b_mat[t, g], b_mat[t + 4, g] = b
    np.testing.assert_allclose(a_mat @ b_mat, c_tile @ m, rtol=1e-12)


# ------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (3, 100, 2, 32),
                                   (2, 200, 4, 128)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, shape, masked, causal):
    q, k, v, mask = _inputs(sum(shape), *shape, masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = tattn.flash_attention_fwd_cuda.launches
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd_cuda.launches == before + 1
    po, plse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
    jo, jlse = jattn.pallas_flash_attention(
        q, k, v, mask, causal=causal, block_q=shape[1], block_k=shape[1],
        interpret=True, precision="highest", return_lse=True)
    np.testing.assert_allclose(o.cpu().numpy(), np.asarray(jo),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda_device):
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda_device)
    q, k, v = qkv.unbind(2)           # non-contiguous (B, T, H, D) views
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    po, plse = tattn.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("masked,causal,T", [(False, True, 130),
                                             (True, False, 77),
                                             (True, True, 77)])
def test_kernel_refuses_unsupported_head_dim(cuda_device, D, masked,
                                             causal, T):
    """Past 128, where the kernels refused until their wide variants
    came, every head dim runs: the forward, dq and dk/dv launchers (one
    launch each, at the next multiple of 128) against the plain
    versions at D."""
    q, k, v, do, mask = _bwd_inputs(D + T, 2, T, 3, D, masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    g = torch.from_numpy(do).to(cuda_device)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = (tattn.flash_attention_fwd_cuda.launches,
              tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal)
    dq, delta = tattn.flash_attention_bwd_dq_cuda(*t, o, lse, g, m,
                                                  causal=causal)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(*t, lse, delta, g, m,
                                                causal=causal)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_fwd_cuda.launches,
            tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == tuple(
        n + 1 for n in before)
    po, plse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
    pdq, pdelta = tattn.flash_attention_bwd_dq_plain(*t, o, lse, g, m,
                                                     causal=causal)
    pdk, pdv = tattn.flash_attention_bwd_dkv_plain(*t, lse, pdelta, g, m,
                                                   causal=causal)
    for a, b in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    if masked:
        assert torch.all(o[1] == 0) and torch.all(dq[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 8, 16, 48, 96, 160, 192])
@pytest.mark.parametrize("masked,causal,T", [(False, True, 64),
                                             (True, False, 100),
                                             (True, True, 77)])
def test_padded_head_dims_match_plain_on_card(cuda_device, D, masked,
                                              causal, T):
    """A head dim the kernels are not built for runs at the next of
    32/64/128 (the backward past 128 at 256), zero-padded, with the true
    D's scale, and the forward at 160 and 192 reads D in place: the
    forward, dq and dk/dv launches (one each) against the plain versions
    at D."""
    q, k, v, do, mask = _bwd_inputs(D + T, 2, T, 3, D, masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    g = torch.from_numpy(do).to(cuda_device)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = (tattn.flash_attention_fwd_cuda.launches,
              tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal)
    dq, dk, dv = tattn.flash_attention_bwd(*t, o, lse, g, m, causal=causal)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_fwd_cuda.launches,
            tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == tuple(
        n + 1 for n in before)
    assert o.shape == dq.shape == dk.shape == dv.shape == (2, T, 3, D)
    po, plse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
    want = tattn.flash_attention_bwd_plain(*t, po, plse, g, m,
                                           causal=causal)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 333])
@pytest.mark.parametrize("D", [136, 160, 192, 256, 130])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_pair_fwd_kernel_matches_plain_on_card(cuda_device, T, D, masked,
                                               causal):
    """The forward past 128 (flash_fwd_pair_kernel; 130 through the
    padded route, at 256): one launch, against the plain version at D,
    with ragged T at the 16-key tile's and the 64-row CTA's edges; with
    the mask batch 0 tail-padded and batch 1 fully masked (o = 0,
    lse = -1e30)."""
    q, k, v, mask = _inputs(T + D + 2 * masked + causal, 3, T, 2, D,
                            masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = tattn.flash_attention_fwd_cuda.launches
    o, lse = tattn.flash_attention_fwd_cuda(*t, m, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd_cuda.launches == before + 1
    assert o.shape == (3, T, 2, D) and o.is_contiguous()
    po, plse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
    if masked:
        assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)


@pytest.mark.cuda
def test_pair_fwd_kernel_reads_a_view_in_place(cuda_device, monkeypatch):
    """q, k, v as (B, T, H, 160) views of one wider buffer reach the
    kernel as they are: no pad, no copy (the launch gets their
    pointers), and o comes back at 160."""
    buf = torch.randn(2, 100, 3, 4, 256, device=cuda_device)
    q, k, v = buf[..., :160].unbind(2)
    want = tattn.flash_attention_fwd_plain(q, k, v, causal=True)

    def no_pad(*a, **kw):
        raise AssertionError("pad_head_dim called on the in-place path")
    launched = []
    launch = tattn._launch

    def spy(fn, name, q_, pointers, *rest):
        launched.append(pointers)
        return launch(fn, name, q_, pointers, *rest)
    monkeypatch.setattr(tattn, "pad_head_dim", no_pad)
    monkeypatch.setattr(tattn, "_launch", spy)
    o, lse = tattn.flash_attention_fwd_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert launched[0][:3] == [x.data_ptr() for x in (q, k, v)]
    assert o.shape == (2, 100, 4, 160)
    torch.testing.assert_close(o, want[0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, want[1], atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 2, 64), (3, 100, 2, 32),
                                   (2, 200, 4, 128)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernels_match_plain_on_card(cuda_device, shape, masked,
                                         causal):
    q, k, v, do, mask = _bwd_inputs(sum(shape), *shape, masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    g = torch.from_numpy(do).to(cuda_device)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal)
    before = (tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    dq, delta = tattn.flash_attention_bwd_dq_cuda(*t, o, lse, g, m,
                                                  causal=causal)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(*t, lse, delta, g, m,
                                                causal=causal)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    pdq, pdelta = tattn.flash_attention_bwd_dq_plain(*t, o, lse, g, m,
                                                     causal=causal)
    pdk, pdv = tattn.flash_attention_bwd_dkv_plain(*t, lse, pdelta, g, m,
                                                   causal=causal)
    for a, b in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    if masked:
        assert torch.all(dq[1] == 0)


@pytest.mark.cuda
def test_bwd_kernels_read_strided_inputs(cuda_device):
    qkv = torch.randn(2, 96, 3, 4, 64, device=cuda_device)
    q, k, v = qkv.unbind(2)           # non-contiguous (B, T, H, D) views
    do = torch.randn(2, 96, 8, 64, device=cuda_device)[:, :, ::2]
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    got = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


# (B, T, H, masked, causal): the backward past 128 at D = 160, 192 (both
# padded to 256) and 256, where the two-warpgroup kernels run: causal,
# non-causal, a key mask with batch 1 fully masked, ragged T = 333 and
# 1000, and 4 heads at the LM's T
PAIR_CASES = [(2, 512, 3, False, True), (2, 512, 3, False, False),
              (3, 256, 2, True, True), (3, 333, 2, True, False),
              (2, 1000, 2, True, True), (2, 1024, 4, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 192, 256])
@pytest.mark.parametrize("B,T,H,masked,causal", PAIR_CASES)
def test_pair_bwd_kernels_match_plain_on_card(cuda_device, D, B, T, H,
                                              masked, causal):
    """dq/delta and dk/dv of the pair kernels (one launch each) against
    the plain versions at D, dq = 0 on the fully masked batch, and a
    second launch giving the same bits."""
    q, k, v, do, mask = _bwd_inputs(D + T + H + causal, B, T, H, D, masked)
    t, g, m, o, lse = _bwd_on_card(cuda_device, q, k, v, do, mask, causal)
    runs = []
    for _ in range(2):
        before = (tattn.flash_attention_bwd_dq_cuda.launches,
                  tattn.flash_attention_bwd_dkv_cuda.launches)
        dq, delta = tattn.flash_attention_bwd_dq_cuda(*t, o, lse, g, m,
                                                      causal=causal)
        dk, dv = tattn.flash_attention_bwd_dkv_cuda(*t, lse, delta, g, m,
                                                    causal=causal)
        assert (tattn.flash_attention_bwd_dq_cuda.launches,
                tattn.flash_attention_bwd_dkv_cuda.launches) == (
            before[0] + 1, before[1] + 1)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    pdq, pdelta = tattn.flash_attention_bwd_dq_plain(*t, o, lse, g, m,
                                                     causal=causal)
    pdk, pdv = tattn.flash_attention_bwd_dkv_plain(*t, lse, pdelta, g, m,
                                                   causal=causal)
    for a, b in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    if masked:
        assert torch.all(dq[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,masked,causal", [
    (3, 77, 2, True, True), (3, 77, 2, False, False),
    # 32 causal first rows, whose dq is 0 (dp = delta): the case that
    # one tensor-core accumulator over the 384 columns left past the
    # tolerance
    (8, 333, 4, True, True)])
def test_chunked_bwd_kernels_past_256_on_card(cuda_device, B, T, H, masked,
                                              causal):
    """D = 384 keeps the chunked wide kernels (three 128-wide chunks of
    the output's columns): against the plain versions, twice the same
    bits."""
    q, k, v, do, mask = _bwd_inputs(384 + causal, B, T, H, 384, masked)
    t, g, m, o, lse = _bwd_on_card(cuda_device, q, k, v, do, mask, causal)
    runs = [tattn.flash_attention_bwd_cuda(*t, o, lse, g, m, causal=causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want = tattn.flash_attention_bwd_plain(*t, o, lse, g, m, causal=causal)
    for a, b in zip(runs[0], want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    if masked:
        assert torch.all(runs[0][0][1] == 0)


# dq's first causal query row sees one key, so its exact gradient is 0:
# p = 1, o = v0 and ds = p * (dp - delta) with dp = do . v0 and
# delta = do . o. What the kernel leaves there is its error in
# dp - delta, not a relative error of a nonzero value, so that row gets
# a bound of its own, in units of sum_i |do_i v0_i|:
# - dp runs as 3xTF32: hi keeps 11 significant bits (|lo| <= 2^-12 |a|),
#   the tensor core truncates lo to TF32 (2^-10 of it: 2^-22 |a|) and
#   lo . lo is dropped (2^-24), so each product is off by at most
#   3 * 2^-22;
# - the forward's o = 1 . v0 through the same split is off by 2^-22 |v0|
#   (lo truncated), which delta inherits;
# - the kernel sums dp's 3 * D partial products in the tensor core's f32
#   accumulator, which truncates (2^-23 an add: 6 * D * 2^-24); its
#   delta and the plain version's dp and delta are f32 sums of D terms
#   (D * 2^-24 each: 3 * D * 2^-24).
# So |dq_kernel[0] - dq_plain[0]| <= scale * |k0| * eps * sum|do_i v0_i|
# with eps = 4 * 2^-22 + 9 * D * 2^-24, a worst case (every rounding at
# its largest, all of one sign).
def _first_row_bound(k, v, do, D):
    eps = 4 * 2.0 ** -22 + 9 * D * 2.0 ** -24
    dot = (do[:, 0].abs() * v[:, 0].abs()).sum(-1, keepdim=True)
    return D ** -0.5 * k[:, 0].abs() * eps * dot      # (B, H, D)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(20))
def test_autograd_on_card_launches_both_backward_kernels(cuda_device, seed):
    B, T, H, D = 2, 80, 2, 32
    q, k, v, _ = _inputs(553 + seed, B, T, H, D, False)
    t = [torch.from_numpy(a).to(cuda_device).requires_grad_()
         for a in (q, k, v)]
    before = (tattn.flash_attention_bwd_dq_cuda.launches,
              tattn.flash_attention_bwd_dkv_cuda.launches)
    o = tattn.flash_attention(*t, causal=True)
    got = torch.autograd.grad(o.square().sum(), t)
    assert (tattn.flash_attention_bwd_dq_cuda.launches,
            tattn.flash_attention_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    o2, _ = tattn.flash_attention_fwd_plain(*t, causal=True)
    want = torch.autograd.grad(o2.square().sum(), t)
    # every element at ATOL / RTOL, but dq's first query row ...
    torch.testing.assert_close(got[0][:, 1:], want[0][:, 1:], atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    # ... which is held to the derived bound of dp - delta's error
    resid = (got[0][:, 0] - want[0][:, 0]).abs()
    bound = _first_row_bound(t[1].detach(), t[2].detach(),
                             2 * o.detach(), D)
    rest = max([(got[0][:, 1:] - want[0][:, 1:]).abs().max().item()]
               + [(a - b).abs().max().item()
                  for a, b in zip(got[1:], want[1:])])
    print(f"seed {553 + seed}: dq row 0 residue {resid.max().item():.3e},"
          f" worst residue / bound {(resid / bound).max().item():.3f};"
          f" other elements max |err| {rest:.3e}")
    assert torch.all(resid <= bound)


def _bwd_on_card(device, q, k, v, do, mask, causal):
    t = [torch.from_numpy(a).to(device) for a in (q, k, v)]
    g = torch.from_numpy(do).to(device)
    m = None if mask is None else torch.from_numpy(mask).to(device)
    o, lse = tattn.flash_attention_fwd(*t, m, causal=causal)
    return t, g, m, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernels_give_the_same_bits_twice(cuda_device, masked, causal):
    # no atomics: the sums run in one order on every launch
    q, k, v, do, mask = _bwd_inputs(11 + causal, 2, 333, 4, 64, masked)
    t, g, m, o, lse = _bwd_on_card(cuda_device, q, k, v, do, mask, causal)
    runs = []
    for _ in range(2):
        dq, delta = tattn.flash_attention_bwd_dq_cuda(*t, o, lse, g, m,
                                                      causal=causal)
        dk, dv = tattn.flash_attention_bwd_dkv_cuda(*t, lse, delta, g, m,
                                                    causal=causal)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17, 65, 127])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernels_at_tile_edges_on_card(cuda_device, T, D, causal):
    # batch 0 tail-padded, batch 1 fully masked, batch 2 unmasked
    q, k, v, do, mask = _bwd_inputs(T + D + causal, 3, T, 2, D, True)
    t, g, m, o, lse = _bwd_on_card(cuda_device, q, k, v, do, mask, causal)
    dq, delta = tattn.flash_attention_bwd_dq_cuda(*t, o, lse, g, m,
                                                  causal=causal)
    dk, dv = tattn.flash_attention_bwd_dkv_cuda(*t, lse, delta, g, m,
                                                causal=causal)
    torch.cuda.synchronize()
    pdq, pdelta = tattn.flash_attention_bwd_dq_plain(*t, o, lse, g, m,
                                                     causal=causal)
    pdk, pdv = tattn.flash_attention_bwd_dkv_plain(*t, lse, pdelta, g, m,
                                                   causal=causal)
    for a, b in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    assert torch.all(dq[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 160, 256])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_gives_the_same_bits_twice(cuda_device, masked, causal, D):
    # no atomics: the sums run in one order on every launch (past 128 the
    # pair kernel's two warps over a row add the same two partials)
    q, k, v, mask = _inputs(13 + causal, 2, 333, 4, D, masked)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    runs = [tattn.flash_attention_fwd_cuda(*t, m, causal=causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 15, 16, 17, 65, 127])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_at_tile_edges_on_card(cuda_device, T, D, causal):
    # batch 0 tail-padded, batch 1 fully masked, batch 2 unmasked
    q, k, v, mask = _inputs(T + D + causal, 3, T, 2, D, True)
    t = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    o, lse = tattn.flash_attention_fwd_cuda(*t, m, causal=causal)
    torch.cuda.synchronize()
    po, plse = tattn.flash_attention_fwd_plain(*t, m, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
    assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)
