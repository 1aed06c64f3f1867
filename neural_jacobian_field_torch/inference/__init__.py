"""Serving entry points and the inference toolbox. The sensitivity maps
and the loaders are exported here under the JAX package's names; the
loaders import lazily, since the model imports this package's programs."""

from .sensitivity import (
    JACOBIAN_COLORMAP,
    compute_joint_sensitivity,
    compute_joint_sensitivity_point_cloud,
    visualize_jacobian_chain_structure,
    visualize_joint_sensitivity,
)

_LOADERS = ("parse_camera_json", "load_model", "resolve_checkpoint")


def __getattr__(name):
    if name in _LOADERS:
        from . import loaders

        return getattr(loaders, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
