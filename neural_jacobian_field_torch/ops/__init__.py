from .activations import trunc_exp, density_activation
from .encodings import nerf_positional_encoding, sh_encoding_deg4, nerf_encoding_dim
from .grid_sample import grid_sample_bilinear
from .compositing import render_weights, composite, render_depth
from .pdf import sample_pdf

__all__ = [
    "trunc_exp",
    "density_activation",
    "nerf_positional_encoding",
    "nerf_encoding_dim",
    "sh_encoding_deg4",
    "grid_sample_bilinear",
    "render_weights",
    "composite",
    "render_depth",
    "sample_pdf",
]
