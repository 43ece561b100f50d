"""K3 (the fused SSIM+L1 gradient) and the tie subgradients, port against JAX.

On the CPU the wrappers run their plain versions: plain K3 is held against
the Pallas kernel in interpret mode and against `jax.grad` of the f32 XLA
chain, the K2/K3 autograd Function against the JAX custom VJP built from the
same two Pallas kernels, and the photometric loss with `fused_pred` against
the JAX package's. Inputs come from a numpy seed and hold a block where pred
equals target, so SSIM is exactly 1 there (the clip's bound) and |u| = 0.

Tolerance atol 1e-5: f32 on both sides, the same formula summed in the same
order (plain K3 and the Pallas kernel) or the same math differentiated
another way (autodiff), on O(1) values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_segmentation_with_selfsupervised_depth_tpu.ops import image as jimage
from improving_segmentation_with_selfsupervised_depth_tpu.ops import photometric as jphoto
from improving_segmentation_with_selfsupervised_depth_tpu.ops.pallas.reprojection import (
    fused_reprojection_error,
    fused_reprojection_error_grad,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.data.synthetic import (
    make_synthetic_batch,
    to_device_batch,
)
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import image
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops import photometric
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda import reprojection
from improving_segmentation_with_selfsupervised_depth_tpu_torch.ops.cuda.reprojection import (
    reprojection_error_diff,
    reprojection_error_grad,
    reprojection_error_grad_plain,
)

ATOL = 1e-5
SHAPES = [(2, 3, 16, 24), (1, 3, 13, 19)]


def _inputs(shape, seed):
    """pred, target (NCHW) with pred == target on the top-left block, and g."""
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    pred[:, :, : h // 2, : w // 2] = target[:, :, : h // 2, : w // 2]
    g = rng.standard_normal((n, 1, h, w)).astype(np.float32)
    return pred, target, g


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k3_matches_pallas_interpret_and_autodiff(shape):
    pred, target, g = _inputs(shape, seed=sum(shape))
    got = reprojection_error_grad(_t(pred), _t(target), _t(g)).numpy()
    ref_kernel = fused_reprojection_error_grad(_nhwc(pred), _nhwc(target), _nhwc(g),
                                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref_kernel).transpose(0, 3, 1, 2), atol=ATOL)
    ref_grad = jax.grad(lambda q: jnp.vdot(
        jnp.asarray(g[:, 0]), jphoto.reprojection_loss_nchw(q, jnp.asarray(target))[..., 0]))(
        jnp.asarray(pred))
    np.testing.assert_allclose(got, np.asarray(ref_grad), atol=ATOL)


def test_plain_k3_reps_equals_one_target_per_pred():
    """reps = 3 (the packed scales of one source frame) equals repeating the
    target: pred image m is compared with target image m // reps."""
    pred, target, g = _inputs((6, 3, 10, 12), seed=4)
    target = target[::3].copy()
    packed = reprojection_error_grad_plain(_t(pred), _t(target), _t(g), reps=3)
    repeated = reprojection_error_grad_plain(_t(pred), _t(np.repeat(target, 3, 0)), _t(g))
    assert torch.equal(packed, repeated)
    assert torch.equal(reprojection.reprojection_error(_t(pred), _t(target), reps=3),
                       reprojection.reprojection_error(_t(pred), _t(np.repeat(target, 3, 0))))


@pytest.mark.parametrize("reps", [1, 2])
def test_fused_function_matches_the_jax_custom_vjp(reps):
    """Forward K2 and backward K3 as one autograd Function against the JAX
    custom VJP of `fused_reprojection_error_diff`, assembled from the same
    Pallas kernels in interpret mode (the packaged one launches them compiled)."""
    pred, target, g = _inputs((2 * reps, 3, 16, 24), seed=9 + reps)
    target = target[::reps].copy()

    @jax.custom_vjp
    def fused(p, t):
        return fused_reprojection_error(p, t, interpret=True, band=8)

    def fwd(p, t):
        return fused(p, t), (p, t)

    def bwd(res, ct):
        p, t = res
        return fused_reprojection_error_grad(p, t, ct, interpret=True), jnp.zeros_like(t)

    fused.defvjp(fwd, bwd)
    tgt = np.repeat(target, reps, 0)
    ref, vjp = jax.vjp(lambda p: fused(p, _nhwc(tgt)), _nhwc(pred))
    (ref_grad,) = vjp(_nhwc(g))

    tp = _t(pred).requires_grad_()
    tt = _t(target).requires_grad_()
    out = reprojection_error_diff(tp, tt, reps)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_grad).transpose(0, 3, 1, 2),
                               atol=ATOL)
    assert tt.grad is None  # the target is data


def _old_reprojection_loss_nchw(pred, target):
    """The port's unfused chain before the tie repair: torch.clamp and .abs()."""
    import torch.nn.functional as F

    xp = F.pad(pred, (1, 1, 1, 1), mode="reflect")
    yp = F.pad(target, (1, 1, 1, 1), mode="reflect")
    pool = lambda t: F.avg_pool2d(t, 3, stride=1)  # noqa: E731
    mu_x, mu_y = pool(xp), pool(yp)
    sx = pool(xp * xp) - mu_x * mu_x
    sy = pool(yp * yp) - mu_y * mu_y
    sxy = pool(xp * yp) - mu_x * mu_y
    n = (2 * mu_x * mu_y + image.SSIM_C1) * (2 * sxy + image.SSIM_C2)
    d = (mu_x * mu_x + mu_y * mu_y + image.SSIM_C1) * (sx + sy + image.SSIM_C2)
    ssim = torch.clamp((1.0 - n / d) * 0.5, 0.0, 1.0).mean(1, keepdim=True)
    return 0.85 * ssim + 0.15 * (target - pred).abs().mean(1, keepdim=True)


def test_tie_subgradients_match_jax():
    """Where pred equals target (SSIM 1 exactly, |u| = 0) and neighbouring
    disparities are equal, torch.clamp / .abs() take other subgradients than
    JAX; the port's chain takes JAX's."""
    pred, target, g = _inputs((2, 3, 16, 24), seed=21)
    ref = jax.grad(lambda q: jnp.vdot(
        jnp.asarray(g[:, 0]), jphoto.reprojection_loss_nchw(q, jnp.asarray(target))[..., 0]))(
        jnp.asarray(pred))

    def torch_grad(fn):
        q = _t(pred).requires_grad_()
        (fn(q, _t(target)) * _t(g)).sum().backward()
        return q.grad.numpy()

    old = torch_grad(_old_reprojection_loss_nchw)
    new = torch_grad(photometric.reprojection_loss_nchw)
    ref = np.asarray(ref)
    print(f"reprojection_loss_nchw gradient, max |port - jax.grad|: before the repair "
          f"{np.abs(old - ref).max():.4g}, after {np.abs(new - ref).max():.4g} "
          f"(max |jax.grad| {np.abs(ref).max():.4g})")
    assert np.abs(old - ref).max() > 1e-3  # the fault the repair removes
    np.testing.assert_allclose(new, ref, atol=ATOL)

    rng = np.random.default_rng(22)
    disp = rng.uniform(0, 1, (2, 1, 8, 12)).astype(np.float32)
    disp[:, :, :4] = 0.5  # equal neighbours: |disp_x - disp_x+1| = 0
    img = rng.uniform(0, 1, (2, 3, 8, 12)).astype(np.float32)
    ref = jax.grad(lambda d: jimage.smoothness_loss(d, _nhwc(img)))(_nhwc(disp))
    d_new = _t(disp).requires_grad_()
    image.smoothness_loss(d_new, _t(img)).backward()
    np.testing.assert_allclose(d_new.grad.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               atol=1e-7)
    d_old = _t(disp).requires_grad_()
    gx = (d_old[..., :-1] - d_old[..., 1:]).abs() * torch.exp(
        -(_t(img)[..., :-1] - _t(img)[..., 1:]).abs().mean(1, keepdim=True))
    gy = (d_old[..., :-1, :] - d_old[..., 1:, :]).abs() * torch.exp(
        -(_t(img)[..., :-1, :] - _t(img)[..., 1:, :]).abs().mean(1, keepdim=True))
    (gx.mean() + gy.mean()).backward()
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    print(f"smoothness_loss gradient, max |port - jax.grad|: before the repair "
          f"{np.abs(d_old.grad.numpy() - ref).max():.4g}, after "
          f"{np.abs(d_new.grad.numpy() - ref).max():.4g} (max |jax.grad| {np.abs(ref).max():.4g})")
    assert np.abs(d_old.grad.numpy() - ref).max() > 1e-4


def test_min_over_sources_splits_ties_like_jax():
    comb = np.array([[[[0.3]], [[0.3]], [[0.7]]]], np.float32)  # (1, 3, 1, 1)
    ref = jax.grad(lambda c: jnp.sum(jnp.min(c, axis=1)))(jnp.asarray(comb))
    c = _t(comb).requires_grad_()
    c.amin(1).sum().backward()
    np.testing.assert_array_equal(c.grad.numpy(), np.asarray(ref))


@pytest.mark.parametrize("fused_pred", [False, True])
def test_photometric_loss_and_gradient_match_jax(fused_pred):
    """compute_losses (pack layout), the loss and its gradient w.r.t. the
    warped predictions and the disparities, against the JAX package (whose
    fused path on the CPU is the XLA chain, the same math). Both sides get
    the same warped predictions, so the warp's kinks at integer coordinates
    cannot amplify op-order rounding into the comparison."""
    rng = np.random.default_rng(15)
    n, s_, h, w = 2, 4, 32, 48
    batch = make_synthetic_batch(n, h, w, frame_ids=(0, -1, 1), num_scales=4, seed=16)
    disps = [rng.uniform(0.05, 0.95, (n, h >> s, w >> s, 1)).astype(np.float32)
             for s in range(4)]
    # warped predictions: the target frame shifted and perturbed, with ties
    tgt = batch["color_0_0"].transpose(0, 3, 1, 2)
    packs = {}
    for f in (-1, 1):
        p = np.repeat(np.roll(tgt, f, axis=3)[:, None], s_, 1)
        p = p + rng.normal(0, 0.02, p.shape).astype(np.float32)
        p[:, :, :, : h // 2] = tgt[:, None, :, : h // 2]  # pred == target rows
        packs[f] = p.astype(np.float32)
    kw = dict(scales=(0, 1, 2, 3), frame_ids=(0, -1, 1))
    key = jax.random.PRNGKey(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(ds, ps):
        outs = {f"disp_{s}": d for s, d in enumerate(ds)}
        for f, p in ps.items():
            for s in range(4):
                outs[f"color_pred_{f}_{s}"] = p[:, s]
        return jphoto.compute_losses(key, jb, outs, disparity_smoothness=1e-3,
                                     pred_layout="pack", fused_pred=fused_pred, **kw)["loss"]

    ref, (ref_dd, ref_dp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        [jnp.asarray(d) for d in disps], {f: jnp.asarray(p) for f, p in packs.items()})
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (n, h, w, 2)))

    td = [_t(d.transpose(0, 3, 1, 2)).requires_grad_() for d in disps]
    tp = {f: _t(p).requires_grad_() for f, p in packs.items()}
    outs = {f"disp_{s}": d for s, d in enumerate(td)}
    for f, p in tp.items():
        outs[f"color_pred_pack_{f}"] = p
        for s in range(4):
            outs[f"color_pred_{f}_{s}"] = p[:, s]
    launches = reprojection.reprojection_error_grad.launches
    got = photometric.compute_losses(to_device_batch(batch, "cpu"), outs,
                                     disparity_smoothness=1e-3, fused_pred=fused_pred,
                                     tie_break_noise=_t(noise.transpose(0, 3, 1, 2)), **kw)
    got["loss"].backward()
    assert reprojection.reprojection_error_grad.launches == launches  # CPU: plain versions
    np.testing.assert_allclose(float(got["loss"].detach()), float(ref), rtol=1e-5)
    for s in range(4):
        np.testing.assert_allclose(td[s].grad.numpy(), np.asarray(ref_dd[s]).transpose(0, 3, 1, 2),
                                   atol=1e-6, err_msg=f"disp_{s}")
    for f in (-1, 1):
        np.testing.assert_allclose(tp[f].grad.numpy(), np.asarray(ref_dp[f]), atol=1e-6,
                                   err_msg=f"color_pred_pack_{f}")
