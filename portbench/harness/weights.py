"""Seeded weights made on the device: every leaf of a parameter spec
(`reference.model.parameter_spec`) drawn from one normal and one uniform
draw of a CUDA (or CPU) generator, then cut and scaled leaf by leaf. The
program and the reference are both given these tensors."""

import math
from typing import Dict, List, Tuple

import torch

# distribution -> (draw, scale of a leaf of this shape)
_NORMAL = {
    "kaiming_out": lambda s: math.sqrt(2.0 / (s[0] * s[1] * s[3])),  # HWIO
    "kaiming_in": lambda s: math.sqrt(2.0 / s[-1]),  # [out, in]
    "kaiming_in_small": lambda s: 0.25 * math.sqrt(2.0 / s[-1]),
    "near_zero": lambda s: 1e-4,
    "normal": lambda s: 1.0,
}
_UNIFORM = {
    "torch_linear": lambda s: (-math.sqrt(1.0 / s[-1]), math.sqrt(1.0 / s[-1])),
}


def serving(spec: List[Tuple[str, tuple, str]]) -> List[Tuple[str, tuple, str, float]]:
    """The spec as a served model holds it: a Jacobian head that varies over
    the scene (a ResnetFC head at the density head's scale with its output
    layer at a hundredth, a linear head at a fiftieth of its kaiming
    scale); the BatchNorm running statistics are set by
    `running_statistics`."""
    out = []
    for name, shape, kind in spec:
        scale = 1.0
        if ".jacobian_head" in name:
            if name.endswith(".weight"):
                kind = "kaiming_in_small" if "_fc_1" in name else "kaiming_in"
                scale = 0.01 if ".lin_out" in name else (0.02 if name.count(".") == 2 else 1.0)
            else:
                kind = "zeros"
        out.append((name, shape, kind, scale))
    return out


def training(spec: List[Tuple[str, tuple, str]]) -> List[Tuple[str, tuple, str, float]]:
    """The spec with the initial distributions it names."""
    return [(name, shape, kind, 1.0) for name, shape, kind in spec]


@torch.no_grad()
def make_weights(leaves: List[Tuple[str, tuple, str, float]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 tensors on `device`, the same for the same seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in leaves if kind in table)
             for k, table in (("n", _NORMAL), ("u", _UNIFORM))}
    normal = torch.randn(sizes["n"], generator=g, device=device)
    uniform = torch.rand(sizes["u"], generator=g, device=device)
    at = {"n": 0, "u": 0}
    out = {}
    for name, shape, kind, scale in leaves:
        n = math.prod(shape)
        if kind in _NORMAL:
            t = normal[at["n"]:at["n"] + n] * (_NORMAL[kind](shape) * scale)
            at["n"] += n
        elif kind in _UNIFORM:
            lo, hi = _UNIFORM[kind](shape)
            t = (uniform[at["u"]:at["u"] + n] * (hi - lo) + lo) * scale
            at["u"] += n
        elif kind == "ones":
            t = torch.ones(n, device=device)
        elif kind == "zeros":
            t = torch.zeros(n, device=device)
        else:
            raise ValueError(f"unknown distribution {kind!r} of {name}")
        out[name] = t.reshape(shape).clone()
    return out


@torch.no_grad()
def running_statistics(params: Dict[str, torch.Tensor], image: torch.Tensor,
                       num_layers: int) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    `image` (a seeded frame, not one of a run's requests) through the
    encoder in training mode, layer by layer, as a trained encoder's
    statistics describe the images it serves: random statistics would let
    the eval-mode activations grow or vanish through the sixteen blocks."""
    from portbench.reference.model import Precision, encode

    updates: Dict[str, torch.Tensor] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:  # the same bits every time: no TF32, cuDNN's deterministic algorithms
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            encode(params, image, num_layers, True, Precision(), updates, momentum=0.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in updates.items():
        params[k].copy_(v)


@torch.no_grad()
def served_density(params: Dict[str, torch.Tensor], model: dict, target: dict,
                   image: torch.Tensor, rays, ctx_ext: torch.Tensor, ctx_intr: torch.Tensor,
                   g: torch.Generator, samples: int = 64) -> None:
    """Set the density channel of each density head's output layer (the
    proposal networks' and the decoder's) so that its raw output, over
    points drawn uniformly along `rays` (steps.Rays) through the encoding
    of `image`, has the mean and the standard deviation that `target` states
    ("raw_mean", "raw_std"). A trained field is nearly empty in most of
    a ray and dense at surfaces; the drawn weights' raw densities instead
    sit at one level for the whole scene, a random one, so that every ray
    is opaque at its first sample, or clear. The
    BatchNorm statistics must be set first (`running_statistics`)."""
    from portbench.reference.model import Precision, encode, ray_knots, trunk_features
    from portbench.reference.steps import Field

    field = Field(model, params, Precision())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            pyr = encode(params, image, model["encoder"]["num_layers"], False, field.q, {})
        knots = ray_knots(pyr, rays.origins, rays.directions, rays.near, rays.far, ctx_ext,
                          ctx_intr, tuple(model["rendering"]["epipolar_knots"]))
        b, r = rays.near.shape
        t = rays.near[..., None] + (rays.far - rays.near)[..., None] * torch.rand(
            (b, r, samples), generator=g, device=image.device)
        pos = rays.origins[:, :, None] + t[..., None] * rays.directions[:, :, None]
        z, pe = field.point_inputs(knots, pos, ctx_ext, ctx_intr)
        heads = [(f"proposal_networks_{i}.density_head", model["density_decoder"]["mlp"], 0)
                 for i in range(len(model["rendering"]["num_proposal_samples"]))]
        heads.append(("decoder.density_head", model["action_decoder"]["mlp"],
                      model["action_decoder"]["geometry_feature_dim"]))
        for prefix, mlp, ch in heads:
            feats = trunk_features(params, prefix, mlp, z, pe, field.q).reshape(-1, mlp["d_hidden"])
            w, bias = params[f"{prefix}.lin_out.weight"], params[f"{prefix}.lin_out.bias"]
            raw = feats @ w[ch] + bias[ch]
            scale = target["raw_std"] / float(raw.std())
            w[ch].mul_(scale)
            bias[ch] = (bias[ch] - raw.mean()) * scale + target["raw_mean"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
