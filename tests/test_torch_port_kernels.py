"""K1 (warp) and K2 (fused SSIM+L1 error) of the port against the JAX package.

On the CPU the port's wrappers run their plain versions; these are held
against the JAX functions on inputs made from a numpy seed. The kernels
themselves build and run only on a CUDA card, whose machine has no JAX: the
kernel-against-plain tests are in tests/test_torch_port_cuda.py. The last
tests here check that nothing falls back to the plain version when a CUDA
tensor is given without a card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jax_resample
from improving_segmentation_with_selfsupervised_depth_tpu.ops.pallas.reprojection import (
    fused_reprojection_error,
)
from improving_segmentation_with_selfsupervised_depth_tpu.ops.pallas.warp import (
    bilinear_warp_corners_nchw,
)
from improving_segmentation_with_selfsupervised_depth_tpu.ops.photometric import (
    reprojection_loss,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import warp
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda.reprojection import (
    reprojection_error,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.resample import (
    grid_sample_pack_nchw,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def xla_warp():
    """The JAX package's full-f32 XLA warp, restored to its setting after."""
    saved = dict(jax_resample._WARP_CONFIG)
    jax_resample.configure_warp("xla")
    yield
    jax_resample._WARP_CONFIG.update(saved)


def _images_and_grids(n, s, h, w, seed):
    """NHWC image and (N, S, H, W, 2) grids around the identity, with rows far
    out of range on both axes (border clamps)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    gx = gx + rng.normal(0, 0.05, (n, s, h, w))
    gy = gy + rng.normal(0, 0.05, (n, s, h, w))
    gx[:, :, :2] += rng.uniform(-3, 3, (n, s, 2, w))
    gy[:, :, -2:] += rng.uniform(-3, 3, (n, s, 2, w))
    return img, np.stack([gx, gy], -1).astype(np.float32)


def _port_warp(img, grids):
    n, s, h, w, _ = grids.shape
    out = warp.warp_bilinear_nchw(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                                  torch.from_numpy(grids.reshape(n * s, h, w, 2)), reps=s)
    return [t.reshape(n, s, 3, h, w).numpy() for t in out]


@pytest.mark.parametrize("shape", [(2, 2, 16, 24), (1, 4, 37, 61)])
def test_warp_plain_matches_jax_f32(shape):
    img, grids = _images_and_grids(*shape, seed=3)
    ref = jax_resample._pack_fallback_coeffs(jnp.asarray(img), jnp.asarray(grids))
    for name, g, r in zip(("out", "dfx", "dfy"), _port_warp(img, grids), ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, err_msg=name)


def test_warp_plain_matches_pallas_interpret():
    # the Pallas kernel rounds pixel values through bf16 (ops/pallas/warp.py:30-35):
    # bf16 tolerance on [0, 1] values; an indexing fault would be O(0.1)
    n, s, h, w = 2, 2, 16, 128
    img, grids = _images_and_grids(n, s, h, w, seed=5)
    ix = (grids[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (grids[..., 1] + 1.0) * 0.5 * (h - 1)
    ref = bilinear_warp_corners_nchw(jnp.asarray(img), jnp.asarray(ix.reshape(n * s, h, w)),
                                     jnp.asarray(iy.reshape(n * s, h, w)), reps=s,
                                     interpret=True)
    for name, g, r in zip(("out", "dfx", "dfy"), _port_warp(img, grids), ref):
        np.testing.assert_allclose(g, np.asarray(r).reshape(n, s, 3, h, w), atol=1e-2,
                                   err_msg=name)


def test_warp_grid_gradient_matches_jax(xla_warp):
    img, grids = _images_and_grids(2, 2, 16, 24, seed=7)
    ct = np.random.default_rng(8).standard_normal((2, 2, 3, 16, 24)).astype(np.float32)
    ref = jax.grad(lambda g: jnp.vdot(ct, jax_resample.grid_sample_pack_nchw(
        jnp.asarray(img), g)))(jnp.asarray(grids))

    g = torch.from_numpy(grids).requires_grad_()
    out = grid_sample_pack_nchw(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()), g)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 20, 24, 3), (2, 24, 24, 1)])
def test_reprojection_plain_matches_jax(shape):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    target[:, : shape[1] // 2, : shape[2] // 2] = pred[:, : shape[1] // 2, : shape[2] // 2]
    got = reprojection_error(torch.from_numpy(pred.transpose(0, 3, 1, 2).copy()),
                             torch.from_numpy(target.transpose(0, 3, 1, 2).copy()))
    got = got.numpy().transpose(0, 2, 3, 1)
    for ref in (fused_reprojection_error(jnp.asarray(pred), jnp.asarray(target),
                                         interpret=True, band=8),
                reprojection_loss(jnp.asarray(pred), jnp.asarray(target))):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    img = torch.rand(2, 3, 8, 8)
    grid = torch.rand(4, 8, 8, 2)
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img, grid, reps=3)  # 4 grids for 2 images x 3
    with pytest.raises(TypeError):
        warp.warp_bilinear_nchw(img.double(), grid, reps=2)
    with pytest.raises(TypeError):
        warp.warp_bilinear_nchw(img, grid.double(), reps=2)
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img, torch.rand(4, 8, 8, 3), reps=2)  # not (x, y) pairs
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img, grid[..., 0], reps=2)  # pixel coordinates, 3-dim
    with pytest.raises(ValueError):
        warp.warp_bilinear_nchw(img[:, :, :0], grid, reps=2)  # no pixel to sample
    with pytest.raises(ValueError):
        reprojection_error(torch.rand(1, 3, 1, 8), torch.rand(1, 3, 1, 8))  # H < 2
    with pytest.raises(ValueError):
        reprojection_error(torch.rand(1, 3, 4, 8), torch.rand(1, 3, 4, 9))


def _run_without_card(code, timeout):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cuda_tensor_without_card_raises_and_does_not_fall_back():
    code = (
        "import torch\n"
        "from torch._subclasses.fake_tensor import FakeTensorMode\n"
        "from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import warp\n"
        "def plain(*a, **k):\n"
        "    raise AssertionError('fell back to the plain version')\n"
        "warp.warp_bilinear_nchw_plain = warp.warp_pixels_plain = plain\n"
        "with FakeTensorMode():\n"
        "    img = torch.empty(2, 3, 8, 8, device='cuda')\n"
        "    grid = torch.empty(4, 8, 8, 2, device='cuda')\n"
        "    try:\n"
        "        warp.warp_bilinear_nchw(img, grid, reps=2)\n"
        "    except RuntimeError as e:\n"
        "        print('raised:', e)\n"
        "    else:\n"
        "        raise SystemExit('no error')\n"
    )
    out = _run_without_card(code, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout


def test_chip_smoke_fails_without_card():
    out = _run_without_card("import runpy; runpy.run_path('chip_smoke.py', "
                            "run_name='__main__')", timeout=60)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
