"""Density + Jacobian decoders (PyTorch counterpart of models/decoders.py).

Ported: the proposal-network density field (DensityDecoderMlp) and the
Jacobian field with a ResnetFC head (ActionDecoderJacobianMlp), with the
shared colour head. The transformer and flow decoders keep their config
classes (so ModelCfg's defaults match the JAX package) but are not ported.

Per point: world xyz -> camera-space NeRF positional encoding + pixel-aligned
knot features -> ResnetFC trunks. The Jacobian head outputs J(x) in
R^{action_dim x 3}; scene flow = J(x) @ action is linear in the action, which
inverse dynamics exploits.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import density_activation
from ..ops.encodings import nerf_encoding_dim, nerf_positional_encoding, sh_encoding_deg4
from . import initializers as init
from .pixel_aligned import get_pixel_aligned_features
from .resnet_fc import MlpCfg, ResnetFC


@dataclass
class PixelEncoding:
    """Context encoding consumed by the decoders: features (PackedPyramid, or
    RayKnots once the rays are known), extrinsics [B, 4, 4] cam2world,
    normalized intrinsics [B, 3, 3], action [B, action_dim]."""

    features: object
    extrinsics: torch.Tensor
    intrinsics: torch.Tensor
    action: torch.Tensor


@dataclass
class DensityHeadOutput:
    density: torch.Tensor  # [B, N, 1]
    density_features: torch.Tensor  # [B, N, geo_dim]
    xyz_features: torch.Tensor  # [B, N, pe_dim]
    pixel_aligned_features: object  # KnotFeatures


@dataclass
class DecoderOutput:
    density: torch.Tensor  # [B, R, S, 1]
    color: torch.Tensor  # [B, R, S, 3]
    flow: Optional[torch.Tensor]  # [B, R, S, 3]; None where not asked for
    action_features: Optional[torch.Tensor]  # [B, R, S, dim]; likewise


@dataclass(frozen=True)
class TransformerCfg:
    attn_feat_dim: int = 64
    attn_head_dim: int = 64
    num_attn_heads: int = 8
    attn_depth: int = 3
    attn_mlp_dim: int = 64


@dataclass(frozen=True)
class DensityDecoderMlpCfg:
    name: str = "density_mlp"
    mlp: MlpCfg = field(default_factory=MlpCfg)
    num_frequencies: int = 10


@dataclass(frozen=True)
class ActionDecoderJacobianMlpCfg:
    name: str = "jacobian_mlp"
    mlp: MlpCfg = field(default_factory=MlpCfg)
    num_frequencies: int = 10
    geometry_feature_dim: int = 15
    use_arm_model: bool = False
    arm_action_dim: Optional[int] = None


@dataclass(frozen=True)
class ActionDecoderJacobianTransformerCfg:
    name: str = "jacobian_transformer"
    mlp: MlpCfg = field(default_factory=MlpCfg)
    transformer: TransformerCfg = field(default_factory=TransformerCfg)
    num_frequencies: int = 10
    geometry_feature_dim: int = 15
    use_arm_model: bool = False
    arm_action_dim: Optional[int] = None


@dataclass(frozen=True)
class ActionDecoderFlowMlpCfg:
    name: str = "flow_mlp"
    mlp: MlpCfg = field(default_factory=MlpCfg)
    num_frequencies: int = 10
    geometry_feature_dim: int = 15
    use_arm_model: bool = False
    arm_action_dim: Optional[int] = None


def action_param_pattern(cfg) -> str:
    """Substring of the parameter names that stage 2 trains; everything else
    is frozen (the reference's `action_param_glob_pattern`)."""
    return {
        "jacobian_mlp": "jacobian_head",
        "jacobian_transformer": "jacobian",
        "flow_mlp": "flow_head",
    }[cfg.name]


def _pe(cam_xyz: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    return nerf_positional_encoding(cam_xyz, num_frequencies, 0.0, num_frequencies - 1.0)


class DensityDecoderMlp(nn.Module):
    """Proposal-network density field."""

    def __init__(self, cfg: DensityDecoderMlpCfg, encoder_dim: int,
                 compute_dtype: Optional[torch.dtype] = None, fused_trunk: bool = False):
        super().__init__()
        self.cfg = cfg
        self.density_head = ResnetFC(cfg.mlp, nerf_encoding_dim(3, cfg.num_frequencies),
                                     1, encoder_dim, compute_dtype,
                                     fused_trunk=fused_trunk)
        self._activation = density_activation("trunc_exp")

    def init_weights(self, g):
        self.density_head.init_weights(g)

    def forward(self, world_space_xyz: torch.Tensor,
                pixel_encoding: PixelEncoding) -> torch.Tensor:
        """[B, R, S, 3] world points -> [B, R, S, 1] densities."""
        b, r, s = world_space_xyz.shape[:3]
        xyz = world_space_xyz.reshape(b, r * s, 3)
        aligned, cam_xyz, _ = get_pixel_aligned_features(
            xyz, pixel_encoding.extrinsics, pixel_encoding.intrinsics,
            pixel_encoding.features)
        raw = self.density_head(aligned, _pe(cam_xyz, self.cfg.num_frequencies))
        return self._activation(raw).reshape(b, r, s, 1)


class _ColorHead(nn.Module):
    """MLP(geometry features ++ SH direction features) -> sigmoid RGB."""

    def __init__(self, d_in: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc1 = nn.Linear(d_in, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc3 = nn.Linear(64, 3)

    def init_weights(self, g):
        for layer in (self.fc1, self.fc2, self.fc3):
            init.torch_linear_(layer.weight, g)
            init.zeros_(layer.bias)

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        x = x.to(dt)
        x = torch.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = torch.relu(F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt)))
        x = F.linear(x, self.fc3.weight.to(dt), self.fc3.bias.to(dt))
        return torch.sigmoid(x.to(torch.float32))


class ActionDecoderJacobianMlp(nn.Module):
    """Jacobian field with a ResnetFC head, plus density and colour."""

    spatial_dim = 3

    def __init__(self, cfg: ActionDecoderJacobianMlpCfg = ActionDecoderJacobianMlpCfg(),
                 action_dim: int = 8, encoder_dim: int = 512,
                 compute_dtype: Optional[torch.dtype] = None, fused_trunk: bool = False):
        super().__init__()
        if cfg.use_arm_model:
            raise NotImplementedError("the arm-model Jacobian head is not ported")
        self.cfg, self.action_dim = cfg, action_dim
        pe_dim = nerf_encoding_dim(3, cfg.num_frequencies)
        self.density_head = ResnetFC(cfg.mlp, pe_dim, cfg.geometry_feature_dim + 1,
                                     encoder_dim, compute_dtype, fused_trunk=fused_trunk)
        self.jacobian_head = ResnetFC(cfg.mlp, pe_dim, self.spatial_dim * action_dim,
                                      encoder_dim, compute_dtype, near_zero_init=True,
                                      fused_trunk=fused_trunk)
        self.color_head = _ColorHead(cfg.geometry_feature_dim + 16, compute_dtype)
        self._activation = density_activation("trunc_exp")

    def init_weights(self, g):
        self.density_head.init_weights(g)
        self.jacobian_head.init_weights(g)
        self.color_head.init_weights(g)

    def compute_density(self, world_space_xyz: torch.Tensor,
                        pixel_encoding: PixelEncoding) -> DensityHeadOutput:
        aligned, cam_xyz, _ = get_pixel_aligned_features(
            world_space_xyz, pixel_encoding.extrinsics, pixel_encoding.intrinsics,
            pixel_encoding.features)
        xyz_features = _pe(cam_xyz, self.cfg.num_frequencies)
        raw = self.density_head(aligned, xyz_features)
        geo = self.cfg.geometry_feature_dim
        return DensityHeadOutput(density=self._activation(raw[..., geo:]),
                                 density_features=raw[..., :geo],
                                 xyz_features=xyz_features,
                                 pixel_aligned_features=aligned)

    def compute_jacobian(self, dho: DensityHeadOutput) -> torch.Tensor:
        return self.jacobian_head(dho.pixel_aligned_features, dho.xyz_features)

    def compute_flow(self, action: torch.Tensor, dho: DensityHeadOutput):
        """action [B, N, A] -> (flow [B, N, 3], J [B, N, A*3])."""
        jacobian = self.compute_jacobian(dho)
        j = jacobian.reshape(*jacobian.shape[:-1], -1, self.spatial_dim)
        return torch.einsum("bnas,bna->bns", j, action), jacobian

    def forward(self, world_space_xyz: torch.Tensor, world_space_dir: torch.Tensor,
                pixel_encoding: PixelEncoding, flow: bool = True) -> DecoderOutput:
        """Density, colour and, with `flow`, the Jacobian and the scene flow
        of the action (else both None, and the Jacobian trunk is not run)."""
        b, r, s = world_space_xyz.shape[:3]
        dho = self.compute_density(world_space_xyz.reshape(b, r * s, 3), pixel_encoding)
        scene_flow = action_features = None
        if flow:
            action = pixel_encoding.action[:, None, :].expand(b, r * s,
                                                              pixel_encoding.action.shape[-1])
            scene_flow, action_features = self.compute_flow(action, dho)
        dirs = (world_space_dir.reshape(b, r * s, 3) + 1.0) / 2.0
        color = self.color_head(torch.cat([dho.density_features, sh_encoding_deg4(dirs)],
                                          dim=-1))

        def unflatten(x):
            return x.reshape(b, r, s, x.shape[-1])

        return DecoderOutput(density=unflatten(dho.density), color=unflatten(color),
                             flow=None if scene_flow is None else unflatten(scene_flow),
                             action_features=None if action_features is None
                             else unflatten(action_features))

    def encode_image(self, world_space_xyz: torch.Tensor, pixel_encoding: PixelEncoding):
        """Density + Jacobian, evaluated once for inverse dynamics.
        Returns ([B, R, S, 1], [B, R, S, A*3])."""
        b, r, s = world_space_xyz.shape[:3]
        dho = self.compute_density(world_space_xyz.reshape(b, r * s, 3), pixel_encoding)
        jacobian = self.compute_jacobian(dho)
        return dho.density.reshape(b, r, s, 1), jacobian.reshape(b, r, s, jacobian.shape[-1])


DECODERS = {
    "density_mlp": (DensityDecoderMlpCfg, DensityDecoderMlp),
    "jacobian_mlp": (ActionDecoderJacobianMlpCfg, ActionDecoderJacobianMlp),
    "jacobian_transformer": (ActionDecoderJacobianTransformerCfg, None),
    "flow_mlp": (ActionDecoderFlowMlpCfg, None),
}


def get_action_decoder(cfg, action_dim: int, encoder_dim: int, compute_dtype=None,
                       fused_trunk: bool = False):
    _, cls = DECODERS[cfg.name]
    if cls is None:
        raise NotImplementedError(f"action decoder {cfg.name!r} is not ported yet")
    return cls(cfg=cfg, action_dim=action_dim, encoder_dim=encoder_dim,
               compute_dtype=compute_dtype, fused_trunk=fused_trunk)
