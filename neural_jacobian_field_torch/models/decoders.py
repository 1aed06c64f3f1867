"""Density + action decoders (PyTorch counterpart of models/decoders.py):

  - DensityDecoderMlp: the proposal-network density field;
  - ActionDecoderJacobianMlp: the Jacobian field with a ResnetFC head;
  - ActionDecoderJacobianTransformer: the Jacobian from each point's query
    token cross-attending into `action_dim` learned index embeddings
    (models/transformer.py), then a float32 Dense head;
  - ActionDecoderFlowMlp: the non-Jacobian baseline, flow from a ResnetFC
    fed the features and the action (not linear in the action, so no
    inverse-dynamics encoding).

Per point: world xyz -> camera-space NeRF positional encoding + pixel-aligned
features -> ResnetFC trunks. A Jacobian head outputs J(x) in
R^{action_dim x 3}; scene flow = J(x) @ action is linear in the action, which
inverse dynamics exploits. With `use_arm_model` each action decoder also
holds a plain ResnetFC arm head (`forward(..., arm=True)`). `remat` wraps
the trunks JAX wraps in nn.remat (the density, Jacobian-MLP and flow heads,
and the proposal nets') in torch.utils.checkpoint; the arm heads are not.
The stage-2 trainable parameters are those whose name holds
`action_param_pattern(cfg)` (training/train.trainable_mask).
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import density_activation
from ..ops.epipolar import KnotFeatures
from ..ops.encodings import nerf_encoding_dim, nerf_positional_encoding, sh_encoding_deg4
from . import initializers as init
from .pixel_aligned import get_pixel_aligned_features
from .resnet_fc import MlpCfg, ResnetFC
from .transformer import Transformer, dense


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


def _cat_features(z) -> torch.Tensor:
    """The pixel-aligned features as one [B, N, C] tensor: interpolated from
    the knots, or the levels concatenated (float32, as JAX promotes the
    bf16 and float32 levels)."""
    if isinstance(z, KnotFeatures):
        return z.concat()
    if isinstance(z, (tuple, list)):
        return torch.cat([t.float() for t in z], dim=-1)
    return z


def _cat(parts) -> torch.Tensor:
    """torch.cat in the parts' promoted dtype (jnp.concatenate's)."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], dim=-1)


class DensityDecoderMlp(nn.Module):
    """Proposal-network density field."""

    def __init__(self, cfg: DensityDecoderMlpCfg, encoder_dim: int,
                 compute_dtype: Optional[torch.dtype] = None, fused_trunk: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.density_head = ResnetFC(cfg.mlp, nerf_encoding_dim(3, cfg.num_frequencies),
                                     1, encoder_dim, compute_dtype,
                                     fused_trunk=fused_trunk, remat=remat)
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


class ActionDecoderBase(nn.Module):
    """Density, colour and flow plumbing shared by the action decoders: the
    density head (a ResnetFC whose first geometry_feature_dim outputs feed
    the colour head), the colour head, and a subclass's action heads
    (`_build_heads`, `compute_flow`)."""

    spatial_dim = 3

    def __init__(self, cfg, action_dim: int = 8, encoder_dim: int = 512,
                 compute_dtype: Optional[torch.dtype] = None, fused_trunk: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.action_dim = cfg, action_dim
        self.compute_dtype = compute_dtype
        pe_dim = nerf_encoding_dim(3, cfg.num_frequencies)
        self.density_head = ResnetFC(cfg.mlp, pe_dim, cfg.geometry_feature_dim + 1,
                                     encoder_dim, compute_dtype, fused_trunk=fused_trunk,
                                     remat=remat)
        self._build_heads(pe_dim, encoder_dim, compute_dtype, fused_trunk, remat)
        self.color_head = _ColorHead(cfg.geometry_feature_dim + 16, compute_dtype)
        self._activation = density_activation("trunc_exp")

    def _arm_head(self, pe_dim: int, d_out: int, d_latent: int, compute_dtype):
        """The arm model's head: a plain ResnetFC (no fused kernel, no remat),
        every linear near zero."""
        return ResnetFC(self.cfg.mlp, pe_dim, d_out, d_latent, compute_dtype,
                        near_zero_init=True)

    def init_weights(self, g):
        for m in self.children():
            if hasattr(m, "init_weights"):
                m.init_weights(g)

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

    def compute_flow(self, action: torch.Tensor, dho: DensityHeadOutput, arm: bool = False,
                     features: bool = True):
        """action [B, N, A] -> (flow [B, N, 3], J [B, N, A*3]); J is computed
        for the flow, so `features` changes nothing here."""
        jacobian = self.compute_jacobian(dho, arm=arm)
        j = jacobian.reshape(*jacobian.shape[:-1], -1, self.spatial_dim)
        return torch.einsum("bnas,bna->bns", j, action), jacobian

    def forward(self, world_space_xyz: torch.Tensor, world_space_dir: torch.Tensor,
                pixel_encoding: PixelEncoding, flow: bool = True, arm: bool = False,
                features: bool = True) -> DecoderOutput:
        """Density, colour and, with `flow`, the scene flow of the action (the
        arm head's with `arm`) and the action features: the Jacobian, or,
        where `features` asks for them, the flow head's block outputs. What
        is not computed is None, and its heads do not run."""
        b, r, s = world_space_xyz.shape[:3]
        dho = self.compute_density(world_space_xyz.reshape(b, r * s, 3), pixel_encoding)
        scene_flow = action_features = None
        if flow:
            action = pixel_encoding.action[:, None, :].expand(b, r * s,
                                                              pixel_encoding.action.shape[-1])
            scene_flow, action_features = self.compute_flow(action, dho, arm=arm,
                                                            features=features)
        dirs = (world_space_dir.reshape(b, r * s, 3) + 1.0) / 2.0
        color = self.color_head(torch.cat([dho.density_features, sh_encoding_deg4(dirs)],
                                          dim=-1))

        def unflatten(x):
            return None if x is None else x.reshape(b, r, s, x.shape[-1])

        return DecoderOutput(density=unflatten(dho.density), color=unflatten(color),
                             flow=unflatten(scene_flow),
                             action_features=unflatten(action_features))

    def encode_image(self, world_space_xyz: torch.Tensor, pixel_encoding: PixelEncoding):
        """Density + Jacobian, evaluated once for inverse dynamics.
        Returns ([B, R, S, 1], [B, R, S, A*3])."""
        b, r, s = world_space_xyz.shape[:3]
        dho = self.compute_density(world_space_xyz.reshape(b, r * s, 3), pixel_encoding)
        jacobian = self.compute_jacobian(dho)
        return dho.density.reshape(b, r, s, 1), jacobian.reshape(b, r, s, jacobian.shape[-1])


class ActionDecoderJacobianMlp(ActionDecoderBase):
    """Jacobian field with a ResnetFC head, plus density and colour."""

    def _build_heads(self, pe_dim, encoder_dim, compute_dtype, fused_trunk, remat):
        cfg = self.cfg
        self.jacobian_head = ResnetFC(cfg.mlp, pe_dim, self.spatial_dim * self.action_dim,
                                      encoder_dim, compute_dtype, near_zero_init=True,
                                      fused_trunk=fused_trunk, remat=remat)
        if cfg.use_arm_model:
            self.jacobian_head_arm = self._arm_head(
                pe_dim, self.spatial_dim * cfg.arm_action_dim, encoder_dim, compute_dtype)

    def compute_jacobian(self, dho: DensityHeadOutput, arm: bool = False) -> torch.Tensor:
        head = self.jacobian_head_arm if arm else self.jacobian_head
        return head(dho.pixel_aligned_features, dho.xyz_features)


class ActionDecoderJacobianTransformer(ActionDecoderBase):
    """Jacobian via cross-attention into learned per-action index embeddings:
    query = jacobian_query_mlp(xyz features ++ pixel-aligned features), the
    transformer's tokens, then a float32 Dense head."""

    def _build_heads(self, pe_dim, encoder_dim, compute_dtype, fused_trunk, remat):
        cfg, tcfg = self.cfg, self.cfg.transformer
        self.jacobian_index_embedding = nn.Parameter(
            torch.zeros(1, self.action_dim, tcfg.attn_feat_dim))
        self.jacobian_query_mlp = nn.Linear(pe_dim + encoder_dim, tcfg.attn_feat_dim)
        self.jacobian_attn_decoder = Transformer(
            dim=tcfg.attn_feat_dim, depth=tcfg.attn_depth, heads=tcfg.num_attn_heads,
            dim_head=tcfg.attn_head_dim, mlp_dim=tcfg.attn_mlp_dim, selfatt=False,
            kv_dim=tcfg.attn_feat_dim, compute_dtype=compute_dtype)
        self.jacobian_head = nn.Linear(tcfg.attn_feat_dim, self.spatial_dim * self.action_dim)
        if cfg.use_arm_model:
            self.jacobian_head_arm = self._arm_head(
                pe_dim, self.spatial_dim * cfg.arm_action_dim, encoder_dim, compute_dtype)

    def init_weights(self, g):
        self.density_head.init_weights(g)
        init.normal_(self.jacobian_index_embedding, 1.0, g)
        init.torch_linear_(self.jacobian_query_mlp.weight, g)
        init.zeros_(self.jacobian_query_mlp.bias)
        self.jacobian_attn_decoder.init_weights(g)
        init.near_zero_normal_(self.jacobian_head.weight, g)
        init.near_zero_normal_(self.jacobian_head.bias, g)
        if self.cfg.use_arm_model:
            self.jacobian_head_arm.init_weights(g)
        self.color_head.init_weights(g)

    def compute_jacobian(self, dho: DensityHeadOutput, arm: bool = False) -> torch.Tensor:
        if arm:
            return self.jacobian_head_arm(dho.pixel_aligned_features, dho.xyz_features)
        query = _cat([dho.xyz_features, _cat_features(dho.pixel_aligned_features)])
        tokens = self.jacobian_attn_decoder(dense(query, self.jacobian_query_mlp, None),
                                            self.jacobian_index_embedding)
        return dense(tokens.float(), self.jacobian_head, None)


class ActionDecoderFlowMlp(ActionDecoderBase):
    """Direct flow baseline: a ResnetFC fed the pixel-aligned features and the
    action, so the flow is not linear in the action and there is no
    Jacobian. JAX calls its head with compute_features=True, which keeps it
    off the fused kernel: here the head is built without it, and its block
    outputs (the action features) are computed only where asked for."""

    def _build_heads(self, pe_dim, encoder_dim, compute_dtype, fused_trunk, remat):
        cfg = self.cfg
        self.flow_head = ResnetFC(cfg.mlp, pe_dim, self.spatial_dim,
                                  encoder_dim + self.action_dim, compute_dtype,
                                  near_zero_init=True, remat=remat)
        if cfg.use_arm_model:
            self.flow_head_arm = self._arm_head(pe_dim, self.spatial_dim,
                                                encoder_dim + cfg.arm_action_dim, compute_dtype)

    def compute_jacobian(self, dho: DensityHeadOutput, arm: bool = False) -> torch.Tensor:
        raise NotImplementedError("flow_mlp has no Jacobian; use compute_flow")

    def compute_flow(self, action: torch.Tensor, dho: DensityHeadOutput, arm: bool = False,
                     features: bool = True):
        """action [B, N, A] -> (flow [B, N, 3], the head's block outputs [B, N,
        n_blocks * d_hidden] float32, or None without `features`)."""
        head = self.flow_head_arm if arm else self.flow_head
        z = _cat([_cat_features(dho.pixel_aligned_features), action])
        if features:
            return head(z, dho.xyz_features, compute_features=True)
        return head(z, dho.xyz_features), None

    def encode_image(self, world_space_xyz, pixel_encoding):
        raise NotImplementedError(
            "flow_mlp does not support the cached-Jacobian inverse-dynamics path "
            "(flow is nonlinear in the action); see action_decoder_flow.py:248-278")


DECODERS = {
    "density_mlp": (DensityDecoderMlpCfg, DensityDecoderMlp),
    "jacobian_mlp": (ActionDecoderJacobianMlpCfg, ActionDecoderJacobianMlp),
    "jacobian_transformer": (ActionDecoderJacobianTransformerCfg,
                             ActionDecoderJacobianTransformer),
    "flow_mlp": (ActionDecoderFlowMlpCfg, ActionDecoderFlowMlp),
}


def get_action_decoder(cfg, action_dim: int, encoder_dim: int, compute_dtype=None,
                       fused_trunk: bool = False, remat: bool = False):
    """The action decoder of cfg.name. fused_trunk sends the ResnetFC heads
    through the K7 kernels in bf16; remat recomputes the trunks' activations
    in the backward."""
    _, cls = DECODERS[cfg.name]
    return cls(cfg=cfg, action_dim=action_dim, encoder_dim=encoder_dim,
               compute_dtype=compute_dtype, fused_trunk=fused_trunk, remat=remat)
