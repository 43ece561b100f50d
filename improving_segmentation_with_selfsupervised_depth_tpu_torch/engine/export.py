"""Ahead-of-time export of the inference forward for serving, through
`torch.export` (the port's counterpart of the JAX package's
`engine/export.py`, which writes StableHLO).

The pose-free eval-mode forward is traced once at a fixed H and W with the
checkpoint's weights in the artifact (`torch.export.save`, a `.pt2` file);
`load_exported(path)` returns a callable
`img (N, 3, H, W) float32 -> {"semantics": logits (N, C, H, W), "disp_0":
disparity (N, 1, H, W)}` that needs no model or config code. The artifact
runs on the device it was exported on. The JAX artifact cannot be shared
with the port; what carries across is the function: the same weights give
the same outputs.

    python -m improving_segmentation_with_selfsupervised_depth_tpu_torch.cli.export_cli \
        --model <run-dir> --out model.pt2
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional

import torch

from ..ops.photometric import key_of

OUTPUTS = ("semantics", "disp_0")


class PoseFreeForward(torch.nn.Module):
    """The model's forward on one image tensor, without the pose network,
    returning only the served outputs."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.model({key_of("color_aug", 0, 0): img}, use_pose=False)
        return {k: out[k] for k in OUTPUTS if out.get(k) is not None}


def export_inference(model: torch.nn.Module, height: int, width: int,
                     batch_size: Optional[int] = 1) -> bytes:
    """The serialized `torch.export` program of the model's pose-free eval
    forward at (`height`, `width`), on the model's device. `batch_size=None`
    exports a symbolic batch dimension (`torch.export.Dim`): one artifact
    serves any batch size; H and W stay fixed."""
    from torch.fx.experimental import _config as fx_config

    device = next(model.parameters()).device
    example_n = 2 if batch_size is None else batch_size
    example = torch.zeros((example_n, 3, height, width), device=device)
    # cuDNN takes at most 65,535 images a call
    dynamic = ({"img": {0: torch.export.Dim("batch", min=1, max=65535)}}
               if batch_size is None else None)
    was_training = model.training
    model.eval()
    try:
        # size-oblivious tracing: a batch of 1 takes the general path, where
        # the example's batch of 2 would otherwise guard the artifact to >= 2
        with torch.no_grad(), fx_config.patch(backed_size_oblivious=True):
            program = torch.export.export(PoseFreeForward(model), (example,),
                                          dynamic_shapes=dynamic)
    finally:
        model.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(path_or_bytes) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """An `export_inference` artifact (a path or its bytes) as a callable
    without gradient."""
    src = io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray)) \
        else path_or_bytes
    module = torch.export.load(src).module()

    def serve(img: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return module(img)

    return serve
