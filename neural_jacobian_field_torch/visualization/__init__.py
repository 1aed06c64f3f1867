"""Validation videos (PyTorch counterpart of the JAX package's
visualization/): the interpolated-camera sweep the training CLI renders,
and the motion and match overlays (cv2, imported only when one is
drawn)."""

from .validation import draw_pixel_motion, draw_point_matches, ping_pong, render_interpolated_view
from .view_interpolation import (
    cosine_smooth,
    generate_wobble,
    interpolate_intrinsics,
    interpolate_pose,
    reproj_best,
)
