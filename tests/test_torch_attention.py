"""The port's flash-attention forward (deeplearning4j_tpu_torch/ops/
attention.py) against the JAX package's.

On the CPU the port's wrapper takes its plain version; it is held
against the Pallas kernel in interpret mode (as
tests/test_native_and_kernels.py runs it), against the JAX dispatch
(blockwise / exact masked attention on the CPU) and against
``_exact_masked``. The CUDA kernel itself runs only on a card: those
tests carry the ``cuda`` marker and skip here.

Tolerance: float32 on both sides, sums in another order, so
atol=2e-5, rtol=2e-4 (o values are O(1), lse values O(log T)).
"""

import os
import shutil

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
def test_kernel_refuses_unsupported_head_dim(cuda_device):
    q = torch.randn(1, 8, 1, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention_fwd(q, q, q)
