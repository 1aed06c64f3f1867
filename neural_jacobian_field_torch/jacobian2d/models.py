"""2D Jacobian-field models (PyTorch counterpart of jacobian2d/models.py).

  - UnetJacobianField: image -> UNet -> a per-pixel Jacobian [command_dim,
    spatial_dim]; flow = J @ command.
  - TransformerJacobianField: a frozen ViT-S/14's patch tokens (DINOv2's
    architecture), nearest-repeated to pixels and concatenated with the RGB,
    -> a UNet decoder -> J. The ViT runs under torch.no_grad(), JAX's
    stop_gradient, so no gradient reaches it.

NHWC throughout: a Jacobian map is [B, H, W, command_dim * spatial_dim], the
flow [B, H, W, spatial_dim]. The module names are Flax's (jacobian_field,
dino, decoder), so `utils/from_jax.from_jax_params_2d` bridges a JAX param
tree and `params_2d_flat` writes one.
"""

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
from torch import nn

from .unet import UNet
from .vit import ViTCfg, ViTS14


@dataclass(frozen=True)
class JacobianFieldCfg:
    name: str = "unet"
    command_dim: int = 2
    spatial_dim: int = 2
    consistency_loss_type: str = "image"
    consistency_loss_weight: float = 0.0


@dataclass(frozen=True)
class UnetJacobianFieldCfg(JacobianFieldCfg):
    name: str = "unet"
    depth: int = 3
    start_filts: int = 32


@dataclass(frozen=True)
class TransformerJacobianFieldCfg(JacobianFieldCfg):
    name: str = "transformer"
    vit: ViTCfg = field(default_factory=ViTCfg)
    decoder_depth: int = 3


class JacobianNetOutput(NamedTuple):
    """jacobian [B, H, W, C * S]; flow [B, H, W, S]."""

    jacobian: torch.Tensor
    flow: torch.Tensor


def _flow_from_jacobian(jacobian: torch.Tensor, cmd: torch.Tensor, spatial_dim: int):
    """einsum("bhwcs,bc->bhws") of the Jacobian map and the command, in
    their promoted dtype (as jnp.einsum's)."""
    j = jacobian.reshape(*jacobian.shape[:-1], -1, spatial_dim)
    dt = torch.promote_types(j.dtype, cmd.dtype)
    return torch.einsum("bhwcs,bc->bhws", j.to(dt), cmd.to(dt))


class UnetJacobianField(nn.Module):
    def __init__(self, cfg: UnetJacobianFieldCfg = UnetJacobianFieldCfg(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.jacobian_field = UNet(3, cfg.command_dim * cfg.spatial_dim, depth=cfg.depth,
                                   start_filts=cfg.start_filts, compute_dtype=compute_dtype)

    def init_weights(self, g: torch.Generator):
        self.jacobian_field.init_weights(g)
        return self

    def compute_jacobian(self, input_img: torch.Tensor) -> torch.Tensor:
        return self.jacobian_field(input_img)

    def get_features(self, input_img: torch.Tensor) -> torch.Tensor:
        return self.jacobian_field(input_img, return_features=True)[1]

    def forward(self, input_img: torch.Tensor, input_cmd: torch.Tensor) -> JacobianNetOutput:
        jacobian = self.compute_jacobian(input_img)
        return JacobianNetOutput(jacobian, _flow_from_jacobian(jacobian, input_cmd,
                                                               self.cfg.spatial_dim))


class TransformerJacobianField(nn.Module):
    """Only the UNet decoder trains: the ViT's features are computed without
    a gradient (the reference freezes DINO), and the optimizer gives its
    parameters a zero update (`train.make_optimizer_2d`)."""

    def __init__(self, cfg: TransformerJacobianFieldCfg = TransformerJacobianFieldCfg(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dino = ViTS14(cfg.vit, compute_dtype=compute_dtype)
        self.decoder = UNet(3 + cfg.vit.dim, cfg.command_dim * cfg.spatial_dim,
                            depth=cfg.decoder_depth, compute_dtype=compute_dtype)

    def init_weights(self, g: torch.Generator):
        self.dino.init_weights(g)
        self.decoder.init_weights(g)
        return self

    def get_features(self, input_img: torch.Tensor) -> torch.Tensor:
        """Patch tokens nearest-repeated to pixel resolution: [B, H, W, dim]."""
        b, h, w, _ = input_img.shape
        ps = self.cfg.vit.patch_size
        with torch.no_grad():
            tokens = self.dino(input_img)
        tokens = tokens.reshape(b, h // ps, w // ps, -1)
        return tokens.repeat_interleave(ps, dim=1).repeat_interleave(ps, dim=2)

    def compute_jacobian(self, input_img: torch.Tensor) -> torch.Tensor:
        feats = self.get_features(input_img)
        x = torch.cat([input_img, feats.to(input_img.dtype)], dim=-1)
        return self.decoder(x)

    def forward(self, input_img: torch.Tensor, input_cmd: torch.Tensor) -> JacobianNetOutput:
        jacobian = self.compute_jacobian(input_img)
        return JacobianNetOutput(jacobian, _flow_from_jacobian(jacobian, input_cmd,
                                                               self.cfg.spatial_dim))


def predict_2d(model: nn.Module, input_img: torch.Tensor,
               input_cmd: torch.Tensor) -> JacobianNetOutput:
    """model(input_img, input_cmd) without a gradient, as a device program:
    captured as a CUDA graph per input shape on the card (JAX jits it,
    visualize.py), eagerly on the CPU and inside `model.programs.eager()`.
    The outputs are copies."""
    from .train import programs_of

    def fwd(img, cmd):
        with torch.no_grad():
            return tuple(model(img, cmd))

    return JacobianNetOutput(*programs_of(model).run((fwd, model), (input_img, input_cmd),
                                                     fwd))


MODELS_2D = {
    "unet": (UnetJacobianFieldCfg, UnetJacobianField),
    "transformer": (TransformerJacobianFieldCfg, TransformerJacobianField),
}


def get_model(cfg, compute_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The model of cfg.name (unseeded: call init_weights or load weights)."""
    _, cls = MODELS_2D[cfg.name]
    return cls(cfg=cfg, compute_dtype=compute_dtype)


def _fma_f32(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 acc + x * x rounded once, as a fused multiply-add: x * x is
    exact in float64, their sum is taken there rounded to odd (TwoSum's
    error decides the last bit), so that rounding it to float32 rounds the
    exact sum."""
    a, b = acc.double(), x.double() * x.double()
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _sum_of_squares(j: torch.Tensor) -> torch.Tensor:
    """The sum of squares over the last axis as jnp.linalg.norm's fused
    reduction computes it in float32 on the CPU: x0 x0, then each further
    x_i x_i added by a fused multiply-add."""
    if j.dtype != torch.float32:
        return (j * j).sum(dim=-1)
    acc = j[..., 0] * j[..., 0]
    for i in range(1, j.shape[-1]):
        acc = _fma_f32(acc, j[..., i])
    return acc


def compute_sensitivity(jacobian: torch.Tensor, spatial_dim: int = 2) -> torch.Tensor:
    """Per-command sensitivity ||J_c||, min-max normalised over the image:
    [B, H, W, C * S] -> [B, H, W, C] in [0, 1] (model_wrapper_pusher.py)."""
    j = jacobian.reshape(*jacobian.shape[:-1], -1, spatial_dim)
    sq = _sum_of_squares(j)
    # a correctly rounded square root (PyTorch's vectorised float32 sqrt on
    # the CPU is not always): float64's, rounded to float32
    sens = torch.sqrt(sq.double()).to(sq.dtype) if sq.dtype == torch.float32 else torch.sqrt(sq)
    minima = sens.amin(dim=(-3, -2), keepdim=True)
    maxima = sens.amax(dim=(-3, -2), keepdim=True)
    return torch.clamp((sens - minima) / (maxima - minima + 1e-10), 0.0, 1.0)
