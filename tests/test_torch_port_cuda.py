"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
neither JAX nor the JAX package, so it runs on the card's machine, where JAX
is not installed (the repository's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance 1e-5: both sides are f32; the warp picks identical corners from
identical coordinates and the reprojection kernel sums its windows in the
plain version's order without FMA contraction.
"""

import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import warp
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda.reprojection import (
    reprojection_error,
    reprojection_error_plain,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.resample import (
    grid_sample_pack_nchw,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run on the card only")
    return torch.device("cuda")


def _grids(n, s, h, w, device, seed):
    """(N, S, H, W, 2) grids around the identity with rows far out of range."""
    gen = torch.Generator().manual_seed(seed)
    gy, gx = torch.meshgrid(torch.linspace(-1, 1, h), torch.linspace(-1, 1, w), indexing="ij")
    g = torch.stack([gx, gy], -1).expand(n, s, h, w, 2).clone()
    g += 0.05 * torch.randn(g.shape, generator=gen)
    g[:, :, :2, :, 0] += 6 * torch.rand((n, s, 2, w), generator=gen) - 3
    g[:, :, -2:, :, 1] += 6 * torch.rand((n, s, 2, w), generator=gen) - 3
    return g.to(device)


@pytest.mark.parametrize("shape", [(8, 4, 64, 96), (2, 2, 37, 61), (1, 1, 2, 3)])
def test_warp_kernel_matches_plain(cuda, shape):
    n, s, h, w = shape
    img = torch.rand((n, 3, h, w), generator=torch.Generator().manual_seed(1)).to(cuda)
    ix, iy = warp.unnormalize_grid(_grids(n, s, h, w, cuda, 11).reshape(n * s, h, w, 2), h, w)
    ix, iy = ix.contiguous(), iy.contiguous()
    before = warp.warp_bilinear_nchw.launches
    got = warp.warp_bilinear_nchw(img, ix, iy, reps=s)
    ref = warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s)
    torch.cuda.synchronize()
    assert warp.warp_bilinear_nchw.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == (n * s, 3, h, w)
        assert float((g - r).abs().max()) <= 1e-5


def test_warp_grid_gradient_matches_plain_autograd(cuda):
    n, s, h, w = 2, 2, 33, 47
    img = torch.rand((n, 3, h, w), generator=torch.Generator().manual_seed(2)).to(cuda)
    grids = _grids(n, s, h, w, cuda, 12)
    ct = torch.randn((n, s, 3, h, w), generator=torch.Generator().manual_seed(3)).to(cuda)
    g1 = grids.clone().requires_grad_()
    (grid_sample_pack_nchw(img, g1) * ct).sum().backward()
    # plain autograd through the plain warp at the same pixel coordinates
    g2 = grids.clone().requires_grad_()
    ix, iy = warp.unnormalize_grid(g2.reshape(n * s, h, w, 2), h, w)
    out, _, _ = warp.warp_bilinear_nchw_plain(img, ix, iy, reps=s)
    (out.reshape(n, s, 3, h, w) * ct).sum().backward()
    assert float((g1.grad - g2.grad).abs().max()) <= 1e-4  # sums of 3 channels of O(10) terms


@pytest.mark.parametrize("shape", [(8, 3, 64, 96), (2, 3, 37, 61), (1, 3, 2, 2)])
def test_reprojection_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(2)
    pred = torch.rand(shape, generator=gen).to(cuda)
    target = torch.rand(shape, generator=gen).to(cuda)
    target[..., : shape[2] // 2, :] = 0.5  # flat windows: the variance terms cancel
    before = reprojection_error.launches
    got = reprojection_error(pred, target)
    ref = reprojection_error_plain(pred, target)
    torch.cuda.synchronize()
    assert reprojection_error.launches == before + 1
    assert got.shape == (shape[0], 1, shape[2], shape[3])
    assert float((got - ref).abs().max()) <= 1e-5


def test_kernels_reject_non_contiguous_input(cuda):
    img = torch.rand((2, 3, 8, 8), device=cuda)
    ix = torch.rand((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img.transpose(2, 3), ix, ix, reps=1)
    with pytest.raises(ValueError):
        reprojection_error(img.transpose(2, 3), img)
