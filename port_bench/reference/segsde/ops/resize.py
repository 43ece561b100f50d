"""Bilinear and nearest resizes (NCHW), PyTorch `F.interpolate` semantics.

Port of the JAX package's `ops/resize.py`, which builds the same math from
interpolation-weight matmuls.

Inside `row_bands(bands)` (spatially sharded inference, `parallel/spatial.py`)
a tensor holds one band of a map's rows and `resize_bilinear` resizes in
the map's global row coordinates: by an integer factor up, from the band
and one row of each neighbour's (the map's edge row repeated at its top and
bottom, where `F.interpolate` clamps), or down, from the band alone; any
other factor raises. `upsample2x_nearest` needs no band form: output row i
reads input row i // 2, and every band starts on an even row.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# the row bands of a spatially sharded forward (parallel/spatial.py::RowBands)
_BANDS = None


@contextlib.contextmanager
def row_bands(bands):
    """Inside, `resize_bilinear` reads its input as `bands`' band of rows."""
    global _BANDS
    prev, _BANDS = _BANDS, bands
    try:
        yield
    finally:
        _BANDS = prev


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to `out_hw = (H_out, W_out)`."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    if _BANDS is not None:
        return _band_resize(x, out_hw, align_corners)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=align_corners)


def _band_resize(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """`resize_bilinear` of a band to its band of the resized map. The
    source row of output row o is (o + 1/2) * H_in / H_out - 1/2: shifting o
    by f * r (f = H_out / H_in) shifts it by r rows, so a band extended by one
    row each side and resized by f holds the global result in its middle."""
    h_in, h_out = x.shape[2], out_hw[0]
    if align_corners:
        raise ValueError("no band form of an align_corners resize")
    if h_out % h_in == 0:
        f = h_out // h_in
        if f == 1:
            return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
        ext = _BANDS.exchange(x, 1, 1, "replicate")
        y = F.interpolate(ext, size=((h_in + 2) * f, out_hw[1]), mode="bilinear",
                          align_corners=False)
        return y[:, :, f:-f]
    if h_in % h_out == 0:
        # output row o reads rows f * o + (f - 1) / 2 and the next: inside the band
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    raise ValueError(f"no band form of a resize from {h_in} to {h_out} rows "
                     "(not an integer factor)")


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample (reference models/monodepth_layers.py:202-205)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
