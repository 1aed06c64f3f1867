"""Validation videos (PyTorch counterpart of the JAX package's
visualization/): the interpolated-camera sweep the training CLI renders.
The motion and match overlays are not ported yet."""

from .validation import render_interpolated_view
from .view_interpolation import (
    cosine_smooth,
    generate_wobble,
    interpolate_intrinsics,
    interpolate_pose,
    reproj_best,
)
