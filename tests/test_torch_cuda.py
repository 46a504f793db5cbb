"""The port's CUDA kernels against their plain versions, on a card.

Marked `cuda`: they skip where torch sees no CUDA device (the check runs
inside the fixture, never at import). On a machine with a card:
`python -m pytest -q -m cuda tests/test_torch_cuda.py`. chip_smoke.py
holds the same kernels at the serving path's full-width shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
from repro_torch.kernels.paged_attention.ops import paged_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,window", [(1, 0), (5, 0), (5, 7)])
def test_paged_attention_kernel_matches_plain(card, dtype, tol, Sq, window):
    rng = np.random.default_rng(Sq + window)
    G, B, H, K, dh, page, maxp, pages = 2, 3, 8, 2, 64, 4, 9, 40
    q = torch.from_numpy(rng.standard_normal((G, B, Sq, H, dh))).to(dtype)
    kp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    vp = torch.from_numpy(rng.standard_normal((G, pages, page, K, dh)))
    kp, vp = kp.to(dtype), vp.to(dtype)
    bt = torch.from_numpy(rng.integers(1, pages, (G, B, maxp))).int()
    kv = torch.from_numpy(rng.integers(Sq, maxp * page + 1, (G, B))).int()
    qo = kv - Sq
    args = (q, kp, vp, bt, kv)
    ref = paged_attention(*args, q_offset=qo, window=window)
    dispatch.reset_counts()
    out = paged_attention(*(a.to(card) for a in args), q_offset=qo.to(card),
                          window=window)
    torch.cuda.synchronize()
    assert dispatch.calls("paged_attention") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_grouped_matmul_kernel_matches_plain(card, dtype, tol):
    rng = np.random.default_rng(0)
    E, C, D, W = 5, 70, 96, 130
    x = torch.from_numpy(rng.standard_normal((E, C, D))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, W, D)) / D ** 0.5).to(dtype)
    counts = torch.tensor([0, 3, 70, 64, 65])
    ref = grouped_matmul_ref(x, w, counts)
    dispatch.reset_counts()
    out = grouped_matmul(x.to(card), w.to(card), counts.to(card))
    torch.cuda.synchronize()
    assert dispatch.calls("grouped_matmul") == 1
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=tol,
                               atol=tol)
    assert not out[0].any() and not out[1, 3:].any()
