"""PyTorch/CUDA port of the semi-supervised segmentation + self-supervised
depth framework.

The JAX package `improving_segmentation_with_selfsupervised_depth_tpu` is the
reference; this package mirrors its module paths. Tensors are NCHW. The port
imports neither JAX nor the JAX package.
"""


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """The error for a feature of the JAX package this port does not run yet."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md item: {roadmap_item})")
