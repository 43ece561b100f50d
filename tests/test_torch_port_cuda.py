"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
neither JAX nor the JAX package, so it runs on the card's machine, where JAX
is not installed (the repository's conftest imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerance 1e-5: both sides are f32; the warp unnormalizes the grids with the
same f32 operations and picks identical corners, and the reprojection
kernels sum their windows in the plain versions' order without FMA
contraction. K3's is 1e-5 of the largest gradient value: flat windows
amplify a last-bit difference of a variance term by up to 1/C2^2 in its
coefficients.
"""

import ctypes
import os
import subprocess
from pathlib import Path

import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import _build, warp
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda.reprojection import (
    reprojection_error,
    reprojection_error_diff,
    reprojection_error_grad,
    reprojection_error_grad_plain,
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


KERNEL_TOL = 1e-5


def _warp_against_plain(img, grid, reps):
    """K1 against its plain version, synchronized: the three planes, bit for
    bit within KERNEL_TOL, and one launch counted."""
    before = warp.warp_bilinear_nchw.launches
    got = warp.warp_bilinear_nchw(img, grid, reps=reps)
    ref = warp.warp_bilinear_nchw_plain(img, grid, reps=reps)
    torch.cuda.synchronize()
    assert warp.warp_bilinear_nchw.launches == before + 1
    m, c = grid.shape[0], img.shape[1]
    for g, r in zip(got, ref):
        assert g.shape == (m, c, *grid.shape[1:3])
        assert float((g - r).abs().max()) <= KERNEL_TOL


# planes of an even pixel count (the vector path: 64x96, the main path's
# 512x512, 50x97, 2x3), of an odd one (the scalar path: 37x61, 3x5); C = 3
# (interleaved gathers) and C = 1 and 5 (per-plane gathers)
@pytest.mark.parametrize("shape", [(2, 4, 3, 64, 96), (2, 4, 3, 512, 512), (2, 2, 3, 37, 61),
                                   (1, 4, 3, 50, 97), (1, 1, 3, 2, 3), (1, 2, 3, 3, 5),
                                   (2, 2, 1, 64, 96), (2, 2, 5, 37, 61)])
def test_warp_kernel_matches_plain(cuda, shape):
    n, s, c, h, w = shape
    img = torch.rand((n, c, h, w), generator=torch.Generator().manual_seed(1)).to(cuda)
    grid = _grids(n, s, h, w, cuda, 11).reshape(n * s, h, w, 2)
    _warp_against_plain(img, grid, s)


def _offset(t):
    """`t`'s values in a view whose storage starts one float later."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("c", [3, 1])
def test_warp_kernel_takes_views_with_a_storage_offset(cuda, c):
    n, s, h, w = 2, 2, 16, 24
    img = torch.rand((n, c, h, w), generator=torch.Generator().manual_seed(3)).to(cuda)
    grid = _grids(n, s, h, w, cuda, 13).reshape(n * s, h, w, 2)
    _warp_against_plain(_offset(img), _offset(grid), s)


@pytest.mark.parametrize("c", [3, 1])
def test_warp_kernel_non_finite_and_far_coordinates(cuda, c):
    n, s, h, w = 2, 2, 24, 32
    img = torch.rand((n, c, h, w), generator=torch.Generator().manual_seed(4)).to(cuda)
    grid = _grids(n, s, h, w, cuda, 14).reshape(n * s, h, w, 2)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 3.5,
                             -7.0], device=cuda)
    flat = grid.view(-1)
    where = torch.arange(0, flat.numel(), 5, device=cuda)
    flat[where] = specials[torch.arange(where.numel(), device=cuda) % specials.numel()]
    _warp_against_plain(img, grid, s)


# 21,846 x 3 = 65,538 grids, and 65,537 images: more than a launch's y
# dimension holds (K1's grids, the interleaving launch's images); planes of 4
# pixels (vector path) and of 9 (scalar); C = 3 and 1
@pytest.mark.parametrize("shape", [(21846, 3, 3, 2, 2), (21846, 3, 3, 3, 3),
                                   (65537, 1, 3, 2, 2), (21846, 3, 1, 2, 2)])
def test_warp_kernel_more_grids_than_a_launch_dimension(cuda, shape):
    n, s, c, h, w = shape
    img = torch.rand((n, c, h, w), generator=torch.Generator().manual_seed(5)).to(cuda)
    grid = (4 * torch.rand((n * s, h, w, 2), generator=torch.Generator().manual_seed(6))
            - 2).to(cuda)
    _warp_against_plain(img, grid, s)


def test_warp_grid_gradient_matches_plain_autograd(cuda):
    n, s, h, w = 2, 2, 33, 47
    img = torch.rand((n, 3, h, w), generator=torch.Generator().manual_seed(2)).to(cuda)
    grids = _grids(n, s, h, w, cuda, 12)
    ct = torch.randn((n, s, 3, h, w), generator=torch.Generator().manual_seed(3)).to(cuda)
    g1 = grids.clone().requires_grad_()
    before = warp.warp_bilinear_nchw.launches
    (grid_sample_pack_nchw(img, g1) * ct).sum().backward()
    assert warp.warp_bilinear_nchw.launches == before + 1
    # plain autograd through the plain warp, which unnormalizes the grids
    g2 = grids.clone().requires_grad_()
    out, _, _ = warp.warp_bilinear_nchw_plain(img, g2.reshape(n * s, h, w, 2), reps=s)
    (out.reshape(n, s, 3, h, w) * ct).sum().backward()
    assert float((g1.grad - g2.grad).abs().max()) <= 1e-4  # sums of 3 channels of O(10) terms


# H not a multiple of the kernels' 16-row tiles, W not a multiple of their
# 32- and 30-column strips, W odd, H and W of 2 and 3 (where the folds of the
# padded rows 0 and H+1 land on the same row)
@pytest.mark.parametrize("shape", [(8, 3, 64, 96), (2, 3, 37, 61), (1, 3, 2, 2), (1, 3, 50, 97),
                                   (2, 3, 2, 3), (2, 3, 3, 2), (1, 3, 3, 3), (1, 3, 17, 31)])
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


def _reprojection_inputs(n, reps, h, w, device, seed):
    """pred (N*reps,3,H,W) with a flat block and a block equal to the target,
    target (N,3,H,W), g (N*reps,1,H,W)."""
    gen = torch.Generator().manual_seed(seed)
    pred = torch.rand((n * reps, 3, h, w), generator=gen)
    target = torch.rand((n, 3, h, w), generator=gen)
    pred[..., : h // 2, : w // 2] = 0.25
    target[..., : h // 2, : w // 3] = 0.5
    pred[..., h // 2:, w // 2:] = target.repeat_interleave(reps, 0)[..., h // 2:, w // 2:]
    g = torch.randn((n * reps, 1, h, w), generator=gen)
    return pred.to(device), target.to(device), g.to(device)


# the edge shapes above with reps, and 21,846 x 3 = 65,538 planes: more than a
# grid's z or y dimension holds
@pytest.mark.parametrize("shape", [(2, 4, 64, 96), (2, 1, 37, 61), (1, 2, 13, 19), (1, 1, 2, 2),
                                   (1, 4, 50, 97), (2, 1, 2, 3), (2, 1, 3, 2), (1, 2, 3, 3),
                                   (1, 4, 17, 31), (21846, 1, 2, 2)])
def test_reprojection_kernels_with_reps_match_plain(cuda, shape):
    n, reps, h, w = shape
    pred, target, g = _reprojection_inputs(n, reps, h, w, cuda, seed=sum(shape))
    before = (reprojection_error.launches, reprojection_error_grad.launches)
    got = reprojection_error(pred, target, reps)
    dgot = reprojection_error_grad(pred, target, g, reps)
    ref = reprojection_error_plain(pred, target, reps)
    dref = reprojection_error_grad_plain(pred, target, g, reps)
    torch.cuda.synchronize()
    assert (reprojection_error.launches, reprojection_error_grad.launches) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (n * reps, 1, h, w) and dgot.shape == pred.shape
    assert float((got - ref).abs().max()) <= 1e-5
    assert float((dgot - dref).abs().max()) <= 1e-5 * float(dref.abs().max())


def test_fused_function_runs_k2_forward_and_k3_backward(cuda):
    pred, target, g = _reprojection_inputs(2, 2, 33, 47, cuda, seed=5)
    leaf = pred.clone().requires_grad_()
    before = (reprojection_error.launches, reprojection_error_grad.launches)
    out = reprojection_error_diff(leaf, target, 2)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (reprojection_error.launches, reprojection_error_grad.launches) == (
        before[0] + 1, before[1] + 1)
    dref = reprojection_error_grad_plain(pred, target, g, 2)
    assert float((leaf.grad - dref).abs().max()) <= 1e-5 * float(dref.abs().max())


def test_divisions_by_nine_and_three_are_ieee_divisions(cuda):
    """K2/K3's `div_by<9>` and `div_by<3>` (csrc/div_by.cuh) against the IEEE
    division on all 2^32 floats, built from the test-only div_by_check.cu."""
    src = Path(__file__).with_name("div_by_check.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"div_by_check_{os.getpid()}.so"
    subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                    "-o", str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).division_mismatches
    fn.argtypes, fn.restype = (ctypes.c_void_p, ctypes.c_void_p), ctypes.c_int
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    assert fn(count.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    assert int(count) == 0


def test_kernels_reject_non_contiguous_input(cuda):
    img = torch.rand((2, 3, 8, 8), device=cuda)
    grid = torch.rand((2, 8, 8, 2), device=cuda)
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img.transpose(2, 3), grid, reps=1)
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img, grid.transpose(1, 2), reps=1)
    with pytest.raises(ValueError):
        reprojection_error(img.transpose(2, 3), img)
    g = torch.rand((2, 1, 8, 16), device=cuda)[..., ::2]  # (2, 1, 8, 8), strided
    with pytest.raises(ValueError):
        reprojection_error_grad(img, img, g)
