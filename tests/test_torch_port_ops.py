"""The port's tensor ops and synthetic data against the JAX package's.

Inputs are made from a numpy seed and go through the JAX function (NHWC) and
the port's (NCHW). Tolerance atol 1e-5 (rtol 1e-5 where values exceed 1):
both sides are f32 on the CPU and differ only by op-order rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu.data.synthetic import (
    make_synthetic_batch as jax_make_synthetic_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu.ops import geometry as jgeo
from improving_segmentation_with_selfsupervised_depth_tpu.ops import image as jimage
from improving_segmentation_with_selfsupervised_depth_tpu.ops import losses as jlosses
from improving_segmentation_with_selfsupervised_depth_tpu.ops import photometric as jphoto
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resample as jresample
from improving_segmentation_with_selfsupervised_depth_tpu.ops import resize as jresize
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    camera_matrix,
    make_synthetic_batch,
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import geometry as geo
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import image
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import photometric
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import resize
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.losses import (
    cross_entropy2d,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.resample import grid_sample

from tests.test_torch_port_kernels import xla_warp  # noqa: F401  (fixture)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _close(got, ref, nhwc=False, **kw):
    got = got.detach().numpy()
    if nhwc:
        got = got.transpose(0, 2, 3, 1)
    kw.setdefault("atol", ATOL)
    np.testing.assert_allclose(got, np.asarray(ref), **kw)


def test_synthetic_batch_is_byte_identical():
    ref = jax_make_synthetic_batch(3, 32, 48, frame_ids=(0, -1, 1), num_scales=4, seed=9)
    got = make_synthetic_batch(3, 32, 48, frame_ids=(0, -1, 1), num_scales=4, seed=9)
    assert set(got) == set(ref) - {"onehot_lbl", "is_labeled"}
    for k in got:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k
    t = to_device_batch(got, "cpu")
    assert t["color_0_0"].shape == (3, 3, 32, 48) and t["lbl"].dtype == torch.int64
    assert t["K_0"].shape == (3, 4, 4)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    n, h, w = 2, 12, 20
    disp = rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32)
    aa = (0.1 * rng.standard_normal((n, 1, 3))).astype(np.float32)
    tr = (0.1 * rng.standard_normal((n, 1, 3))).astype(np.float32)
    K = np.broadcast_to(camera_matrix(h, w), (n, 4, 4)).copy()
    inv_K = np.linalg.inv(K).astype(np.float32)

    for out, ref in zip(geo.disp_to_depth(_nchw(disp), 0.1, 100.0),
                        jgeo.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)):
        _close(out, ref, nhwc=True, rtol=1e-6)
    _close(geo.rot_from_axisangle(_t(aa)), jgeo.rot_from_axisangle(jnp.asarray(aa)))
    for invert in (False, True):
        _close(geo.transformation_from_parameters(_t(aa), _t(tr), invert),
               jgeo.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr), invert))
    depth = 0.5 + 4.5 * disp  # depths in [0.5, 5]
    pts = geo.backproject_depth(_nchw(depth), _t(inv_K))
    jpts = jgeo.backproject_depth(jnp.asarray(depth), jnp.asarray(inv_K))
    _close(pts, jpts)
    T = jgeo.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr))
    _close(geo.project_3d(pts, _t(K), _t(np.asarray(T)), h, w),
           jgeo.project_3d(jpts, jnp.asarray(K), T, h, w))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(16, 24), (5, 7), (8, 12)])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 3)).astype(np.float32)
    _close(resize.resize_bilinear(_nchw(x), out_hw, align_corners),
           jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners), nhwc=True)


def test_upsample2x_nearest_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 4)).astype(np.float32)
    _close(resize.upsample2x_nearest(_nchw(x)),
           jresize.upsample2x_nearest(jnp.asarray(x)), nhwc=True, atol=0)


def test_ssim_and_smoothness_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 3, 10, 14)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 3, 10, 14)).astype(np.float32)
    y[:, :, :5] = x[:, :, :5]  # identical windows: SSIM 1, the clip's lower bound
    got = image.ssim_nchw(_t(x), _t(y))
    _close(got, jimage.ssim_nchw(jnp.asarray(x), jnp.asarray(y)))
    _close(got, jimage.ssim(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(y.transpose(0, 2, 3, 1))), nhwc=True)
    disp = rng.uniform(0, 1, (2, 10, 14, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 10, 14, 3)).astype(np.float32)
    _close(image.smoothness_loss(_nchw(disp), _nchw(img)),
           jimage.smoothness_loss(jnp.asarray(disp), jnp.asarray(img)))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_and_its_gradients_match_jax(align_corners):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    ct = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)

    def f(i, g):
        return jnp.vdot(ct, jresample.grid_sample(i, g, align_corners))

    ref = jresample.grid_sample(jnp.asarray(img), jnp.asarray(grid), align_corners)
    ref_di, ref_dg = jax.grad(f, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    ti, tg = _nchw(img).requires_grad_(), _t(grid).requires_grad_()
    out = grid_sample(ti, tg, align_corners)
    _close(out, ref, nhwc=True)
    (out * _nchw(ct)).sum().backward()
    _close(ti.grad, ref_di, nhwc=True)
    _close(tg.grad, ref_dg)


@pytest.mark.parametrize("logit_hw", [(16, 24), (8, 12)])
def test_cross_entropy_matches_jax(logit_hw):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, *logit_hw, 19))).astype(np.float32)
    lbl = rng.integers(0, 19, (2, 16, 24)).astype(np.int32)
    lbl[:, :3] = 250
    _close(cross_entropy2d(_nchw(logits), _t(lbl)),
           jlosses.cross_entropy2d(jnp.asarray(logits), jnp.asarray(lbl)))
    all_ignored = np.full_like(lbl, 250)
    assert float(cross_entropy2d(_nchw(logits), _t(all_ignored))) == 0.0


def test_photometric_loss_matches_jax(xla_warp):
    """generate_images_pred + compute_losses (pack layout) from given network
    outputs, with the same tie-break draw on both sides."""
    rng = np.random.default_rng(5)
    n, h, w = 2, 32, 48
    batch = make_synthetic_batch(n, h, w, frame_ids=(0, -1, 1), num_scales=4, seed=6)
    outs = {f"disp_{s}": rng.uniform(0.05, 0.95, (n, h >> s, w >> s, 1)).astype(np.float32)
            for s in range(4)}
    for f in (-1, 1):
        T = jgeo.transformation_from_parameters(
            jnp.asarray(0.01 * rng.standard_normal((n, 3)).astype(np.float32)),
            jnp.asarray(0.05 * rng.standard_normal((n, 3)).astype(np.float32)), f < 0)
        outs[f"cam_T_cam_0_{f}"] = np.asarray(T)
    kw = dict(scales=(0, 1, 2, 3), frame_ids=(0, -1, 1))
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jo = jphoto.generate_images_pred(jb, {k: jnp.asarray(v) for k, v in outs.items()},
                                     min_depth=0.1, max_depth=100.0, pred_layout="pack", **kw)
    ref = jphoto.compute_losses(key, jb, jo, disparity_smoothness=1e-3, pred_layout="pack",
                                **kw)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (n, h, w, 2)))

    tb = to_device_batch(batch, "cpu")
    to = {k: (_nchw(v) if k.startswith("disp") else _t(v)) for k, v in outs.items()}
    po = photometric.generate_images_pred(tb, to, min_depth=0.1, max_depth=100.0, **kw)
    for s in range(4):
        for f in (-1, 1):
            _close(po[f"color_pred_{f}_{s}"], jo[f"color_pred_{f}_{s}"])
    got = photometric.compute_losses(tb, po, disparity_smoothness=1e-3,
                                     tie_break_noise=_nchw(noise), **kw)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
