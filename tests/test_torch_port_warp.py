"""K1's plain version, the grid-taking entry, on the CPU.

K1 takes the photometric loss's grids in [-1, 1] and unnormalizes them in
the kernel. Its plain version is `unnormalize_grid` followed by the warp at
pixel coordinates; these tests hold that entry bit for bit against the
pixel-coordinate warp it replaced (copied below as it stood), against
torch's `grid_sample` and its grid gradient, at non-finite and far
coordinates, and through `GridSamplePackNCHW`. The kernel against this plain
version is in tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import warp
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.resample import (
    grid_sample_pack_nchw,
)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pixel_warp_before(img, ix, iy, reps):
    """The plain warp at pixel coordinates as it was before K1 took grids."""
    n, c, h, w = img.shape
    m, hg, wg = ix.shape
    ix = ix.clamp(-1.0, float(w))
    iy = iy.clamp(-1.0, float(h))
    x0, y0 = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0)[:, None], (iy - y0)[:, None]
    x0c, x1c = x0.clamp(0, w - 1).long(), (x0 + 1).clamp(0, w - 1).long()
    y0c, y1c = y0.clamp(0, h - 1).long(), (y0 + 1).clamp(0, h - 1).long()
    flat = img.reshape(n, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, reps * hg * wg).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape(n, c, reps, hg, wg).transpose(1, 2).reshape(
            m, c, hg, wg)

    g00, g01, g10, g11 = gather(y0c, x0c), gather(y0c, x1c), gather(y1c, x0c), gather(y1c, x1c)
    out = ((1.0 - fx) * (1.0 - fy) * g00 + fx * (1.0 - fy) * g01 + (1.0 - fx) * fy * g10
           + fx * fy * g11)
    dfx = (g01 - g00) * (1.0 - fy) + (g11 - g10) * fy
    dfy = (g10 - g00) * (1.0 - fx) + (g11 - g01) * fx
    return out, dfx, dfy


def _inputs(n, s, c, h, w, seed):
    """Image (N, C, H, W) and (N*S, H, W, 2) grids around the identity, with
    rows pushed far out of range on both axes (border clamps)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, c, h, w)).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    grid = np.stack([gx, gy], -1) + rng.normal(0, 0.05, (n * s, h, w, 2))
    grid[:, :2, :, 0] += rng.uniform(-3, 3, (n * s, 2, w))
    grid[:, -2:, :, 1] += rng.uniform(-3, 3, (n * s, 2, w))
    return torch.from_numpy(img), torch.from_numpy(grid.astype(np.float32))


def _equal(got, ref):
    for name, a, b in zip(("out", "dfx", "dfy"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", [(2, 4, 3, 16, 24), (1, 2, 3, 37, 61), (2, 3, 1, 5, 7),
                                   (1, 2, 5, 9, 8)])
def test_grid_entry_is_unnormalize_then_the_pixel_warp(shape):
    n, s, c, h, w = shape
    img, grid = _inputs(n, s, c, h, w, seed=sum(shape))
    got = warp.warp_bilinear_nchw(img, grid, reps=s)
    assert all(t.shape == (n * s, c, h, w) and t.dtype == torch.float32 for t in got)
    ix, iy = warp.unnormalize_grid(grid, h, w)
    _equal(got, _pixel_warp_before(img, ix, iy, s))
    _equal(got, warp.warp_bilinear_nchw_plain(img, grid, reps=s))


def test_plain_matches_torch_grid_sample_and_its_grid_gradient():
    n, s, c, h, w = 2, 2, 3, 12, 20
    img, grid = _inputs(n, s, c, h, w, seed=4)
    out, dfx, dfy = warp.warp_bilinear_nchw(img, grid, reps=s)
    leaf = grid.clone().requires_grad_()
    ref = F.grid_sample(img.repeat_interleave(s, 0), leaf, mode="bilinear",
                        padding_mode="border", align_corners=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    # grid_sample's grid gradient is the coordinate derivative times
    # (size - 1) / 2 where the coordinate lies inside the image (zero where
    # border padding clips it)
    ct = torch.randn(ref.shape, generator=torch.Generator().manual_seed(5))
    (gg,) = torch.autograd.grad(ref, leaf, ct)
    ix, iy = warp.unnormalize_grid(grid, h, w)
    inside = (ix > 0) & (ix < w - 1) & (iy > 0) & (iy < h - 1)
    assert inside.float().mean() > 0.3
    for d, got, scale in ((0, dfx, 0.5 * (w - 1)), (1, dfy, 0.5 * (h - 1))):
        mine = (ct * got).sum(1) * scale
        torch.testing.assert_close(mine[inside], gg[..., d][inside], rtol=0, atol=1e-4)


def test_non_finite_and_far_coordinates_sample_at_the_border():
    """NaN samples as the coordinate -1, +inf and 1e30 as W (H), -inf and
    -1e30 as -1: the clip the kernel applies (fmaxf first)."""
    n, s, c, h, w = 1, 2, 3, 6, 9
    img, grid = _inputs(n, s, c, h, w, seed=6)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30])
    flat = grid.reshape(-1)
    where = torch.arange(0, flat.numel(), 7)
    flat[where] = specials[torch.arange(where.numel()) % specials.numel()]
    got = warp.warp_bilinear_nchw(img, grid, reps=s)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    ix, iy = warp.unnormalize_grid(grid, h, w)
    ix = torch.where(ix.isnan(), -1.0, ix.clamp(-1.0, float(w)))
    iy = torch.where(iy.isnan(), -1.0, iy.clamp(-1.0, float(h)))
    _equal(got, _pixel_warp_before(img, ix, iy, s))


def test_grid_sample_pack_forward_and_gradient_as_before():
    """`GridSamplePackNCHW` through the grid entry: its forward equals the
    pixel warp of the unnormalized grids, its gradient the saved planes'
    reduction (bit for bit), and both agree with plain autograd through the
    plain warp."""
    n, s, c, h, w = 2, 3, 3, 10, 14
    img, grid = _inputs(n, s, c, h, w, seed=8)
    grids = grid.reshape(n, s, h, w, 2)
    ct = torch.randn((n, s, c, h, w), generator=torch.Generator().manual_seed(9))
    leaf = grids.clone().requires_grad_()
    out = grid_sample_pack_nchw(img, leaf)
    (out * ct).sum().backward()

    ix, iy = warp.unnormalize_grid(grid, h, w)
    ref, dfx, dfy = _pixel_warp_before(img, ix, iy, s)
    assert torch.equal(out, ref.reshape(n, s, c, h, w))
    ct2 = ct.reshape(n * s, c, h, w)
    dgrid = torch.stack([(ct2 * dfx).sum(1) * (0.5 * (w - 1)),
                         (ct2 * dfy).sum(1) * (0.5 * (h - 1))], dim=-1)
    assert torch.equal(leaf.grad, dgrid.reshape(grids.shape))

    leaf2 = grids.clone().requires_grad_()
    plain, _, _ = warp.warp_bilinear_nchw_plain(img, leaf2.reshape(n * s, h, w, 2), reps=s)
    (plain.reshape(n, s, c, h, w) * ct).sum().backward()
    torch.testing.assert_close(leaf.grad, leaf2.grad, rtol=0, atol=1e-4)
