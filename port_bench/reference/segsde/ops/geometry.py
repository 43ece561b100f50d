"""Monodepth camera geometry (NCHW).

Port of the JAX package's `ops/geometry.py`. Depth/disparity tensors are
(N, 1, H, W); matrices are (N, 4, 4). The small contractions are written out
as the JAX functions write them, so both sides round alike.
"""

from __future__ import annotations

import torch


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth). Reference monodepth_layers.py:18-27."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> (N, 4, 4) rotation (Rodrigues)."""
    vec = vec.reshape(-1, 3)
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    return torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zeros,
        xyC + zs, y * yC + ca, yzC - xs, zeros,
        zxC - ys, yzC + xs, z * zC + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1).reshape(-1, 4, 4)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation (N, 3) -> (N, 4, 4)."""
    t = t.reshape(-1, 3)
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return T


def transformation_from_parameters(axisangle: torch.Tensor, translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axisangle, translation), each (N,1,3) or (N,3) -> SE3 (N, 4, 4)."""
    R = rot_from_axisangle(axisangle.reshape(-1, 3))
    t = translation.reshape(-1, 3)
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return R @ T if invert else T @ R


def _pix_coords(h: int, w: int, device) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, h * w)


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth (N, 1, H, W) + inv_K (N, 4, 4) -> homogeneous points (N, 4, H*W)."""
    n, _, h, w = depth.shape
    pix = _pix_coords(h, w, depth.device)
    ik = inv_K[:, :3, :3]
    cam = ik[:, :, 0:1] * pix[0] + ik[:, :, 1:2] * pix[1] + ik[:, :, 2:3] * pix[2]
    cam = depth.reshape(n, 1, h * w) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor, h: int, w: int,
               eps: float = 1e-7) -> torch.Tensor:
    """Points (N, 4, H*W) through K @ T -> sampling grid (N, H, W, 2) in [-1, 1]."""
    n = points.shape[0]
    P = (K @ T)[:, :3, :]
    cam = (P[:, :, 0:1] * points[:, 0:1] + P[:, :, 1:2] * points[:, 1:2]
           + P[:, :, 2:3] * points[:, 2:3] + P[:, :, 3:4] * points[:, 3:4])
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(n, 2, h, w)
    grid = torch.stack([pix[:, 0] / (w - 1), pix[:, 1] / (h - 1)], dim=-1)
    return (grid - 0.5) * 2.0
