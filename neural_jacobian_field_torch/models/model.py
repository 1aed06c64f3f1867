"""The composed neural-Jacobian-field model (PyTorch counterpart of
models/model.py): encode a context image, render views (rgb, depth, flow,
Jacobian features), evaluate the field once for inverse dynamics, and
`forward(train=True)` for the training step (stratified sampling, the
training-mode encoder, and the per-level weights and bin edges the losses
read). The sampler's per-step state is a StepCtx (anneal exponent,
proposal gate, randomness) computed on the host by `step_schedules`.

Submodule and parameter names follow the JAX param tree (encoder,
decoder, proposal_networks_<i>), so utils/from_jax.py maps one onto the
other leaf by leaf.
"""

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops.pixel_gather import FeaturePyramid, PackedPyramid, pack_pyramid
from ..rendering.geometry import project_world_coords_to_camera
from ..rendering.samplers import (
    ProposalSamplerCfg, RayBundle, proposal_anneal, proposal_sample, sdist_edges,
    tdist_edges)
from .decoders import (
    ActionDecoderFlowMlpCfg,
    ActionDecoderJacobianMlpCfg,
    ActionDecoderJacobianTransformerCfg,
    DensityDecoderMlp,
    DensityDecoderMlpCfg,
    PixelEncoding,
    get_action_decoder,
)
from .encoder_resnet import EncoderResnet, EncoderResnetCfg
from .resnet_fc import MlpCfg


@dataclass(frozen=True)
class RenderingCfg:
    num_proposal_samples: Tuple[int, ...] = (256,)
    num_nerf_samples: int = 256
    single_jitter: bool = False
    proposal_warmup: int = 5000
    proposal_update_every: int = 5
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    # K5 resampling kernel (ops/kernels/pdf_resample.py)
    use_pallas_pdf: bool = True
    # "exact": every sample gathers from each pyramid level (reference-numerics
    # bilinear; K1 on the coarse level, the K7 trunk projects the levels);
    # "epipolar": per-ray knot textures interpolated per sample (K7-tz)
    pixel_feature_mode: str = "exact"
    epipolar_knots: Tuple[int, int, int] = (64, 16, 8)
    # K7 / K7-tz trunk kernels (ops/kernels/field_mlp.py) for bf16 models
    use_fused_trunk: bool = False


@dataclass(frozen=True)
class ModelCfg:
    action_dim: int = 8
    rendering: RenderingCfg = field(default_factory=RenderingCfg)
    encoder: EncoderResnetCfg = field(default_factory=EncoderResnetCfg)
    density_decoder: DensityDecoderMlpCfg = field(default_factory=DensityDecoderMlpCfg)
    action_decoder: Union[
        ActionDecoderJacobianMlpCfg,
        ActionDecoderJacobianTransformerCfg,
        ActionDecoderFlowMlpCfg,
    ] = field(default_factory=ActionDecoderJacobianTransformerCfg)


def flagship_model_cfg(**rendering_overrides) -> ModelCfg:
    """The flagship configuration (configurations/model/model_allegro.yaml +
    encoder/image_encoder_resnet.yaml, as bench.py builds it): BatchNorm
    ResNet-34 in pyramid layout with K9 convs, epipolar knots (64, 16, 8),
    fused K7-tz trunks, K5 resampling, jacobian_mlp decoder (ResnetFC 5 x 128,
    combine_layer 3), action_dim 8, 256 proposal + 256 NeRF samples. Run it
    with compute_dtype=torch.bfloat16. `pixel_feature_mode="exact"` selects
    the reference-numerics feature path (model_allegro.yaml's setting for
    ported-checkpoint evaluation): per-sample pyramid gathers with K1 on the
    coarse level, and K7 trunks that project the levels themselves."""
    rendering = RenderingCfg(num_proposal_samples=(256,), num_nerf_samples=256,
                             use_pallas_pdf=True, pixel_feature_mode="epipolar",
                             epipolar_knots=(64, 16, 8), use_fused_trunk=True)
    if rendering_overrides:
        rendering = replace(rendering, **rendering_overrides)
    mlp = MlpCfg(n_blocks=5, d_hidden=128, combine_layer=3, combine_type="mean", beta=0.0)
    return ModelCfg(
        action_dim=8,
        rendering=rendering,
        encoder=EncoderResnetCfg(name="resnet", upsample_interp="bilinear", num_layers=4,
                                 use_first_pool=True, norm_type="batch",
                                 feature_layout="pyramid", conv_impl="pallas"),
        density_decoder=DensityDecoderMlpCfg(mlp=mlp),
        action_decoder=ActionDecoderJacobianMlpCfg(mlp=mlp, num_frequencies=10,
                                                   geometry_feature_dim=15),
    )


@dataclass
class CameraInput:
    input_image: torch.Tensor  # [B, H, W, 3]
    ctxt_extrinsics: torch.Tensor  # [B, 4, 4]
    ctxt_intrinsics: torch.Tensor  # [B, 3, 3]
    trgt_extrinsics: torch.Tensor  # [B, 4, 4]
    trgt_intrinsics: torch.Tensor  # [B, 3, 3]


@dataclass
class RenderingInput:
    origins: torch.Tensor  # [B, R, 3]
    directions: torch.Tensor  # [B, R, 3]
    z_near: torch.Tensor  # [B]
    z_far: torch.Tensor  # [B]


@dataclass
class RobotInput:
    robot_action: torch.Tensor  # [B, A]


@dataclass
class ModelInput:
    camera_input: CameraInput
    rendering_input: RenderingInput
    robot_input: RobotInput


@dataclass
class ModelTarget:
    rgb: torch.Tensor  # [B, R, 3]
    depth: torch.Tensor  # [B, R, 1]
    optical_flow: Optional[torch.Tensor] = None  # [B, R, 2]
    visible_mask: Optional[torch.Tensor] = None  # [B, R]


@dataclass
class ModelOutput:
    rgb: torch.Tensor  # [B, R, 3]
    depth: torch.Tensor  # [B, R, 1]
    optical_flow: torch.Tensor  # [B, R, 2]
    weights_list: Optional[tuple] = None  # per level [B, R, S, 1]
    sdist_list: Optional[tuple] = None  # per level [B, R, S+1] spacing edges
    tdist_list: Optional[tuple] = None  # per level [B, R, S+1] euclidean edges
    action_features: Optional[torch.Tensor] = None  # [B, R, A*3]
    ray_positions: Optional[torch.Tensor] = None  # [B, R, 3]
    ray_positions_warped: Optional[torch.Tensor] = None  # [B, R, 3]
    weights: Optional[torch.Tensor] = None  # [B, R, S]
    steps: Optional[torch.Tensor] = None  # [B, R, S]


@dataclass
class ModelInferenceEncoding:
    """Cached field evaluation for inverse dynamics."""

    density: torch.Tensor  # [B, R, S, 1]
    action_features: torch.Tensor  # [B, R, S, A*3]
    weights: torch.Tensor  # [B, R, S, 1]
    ray_samples_positions: torch.Tensor  # [B, R, S, 3]


@dataclass
class StepCtx:
    """Per-step sampler context (the JAX StepCtx): the proposal weights'
    anneal exponent, the proposal gate `updated` (a host-side bool), and the
    stratified draws' source: a torch.Generator, or explicit per-level draws
    in [0, 1) (samplers.proposal_sample)."""

    anneal: float = 1.0
    updated: bool = True
    generator: Optional[torch.Generator] = None
    draws: Optional[Tuple[torch.Tensor, ...]] = None


def step_schedules(step: int, steps_since_update: int,
                   cfg: RenderingCfg) -> Tuple[float, bool, int]:
    """The reference's anneal and proposal-update schedules on host scalars:
    anneal (mip-NeRF 360 eq. 18 bias, or 1); updated = steps_since_update >
    clip(step / warmup * update_every, 1, update_every) or step < 10; and the
    new steps_since_update. Returns (anneal, updated, new_steps_since_update)."""
    if cfg.use_proposal_weight_anneal:
        anneal = proposal_anneal(step, cfg.proposal_weights_anneal_max_num_iters,
                                 cfg.proposal_weights_anneal_slope)
    else:
        anneal = 1.0
    sched = min(max(step / cfg.proposal_warmup * cfg.proposal_update_every, 1.0),
                float(cfg.proposal_update_every))
    updated = bool(steps_since_update > sched or step < 10)
    return anneal, updated, (0 if updated else steps_since_update) + 1


class Model(nn.Module):
    """Encoder + proposal sampling + Jacobian-field decoder."""

    def __init__(self, cfg: ModelCfg = ModelCfg(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        fused = cfg.rendering.use_fused_trunk
        self.encoder = EncoderResnet(cfg.encoder, compute_dtype)
        encoder_dim = EncoderResnet.output_dim(cfg.encoder)
        self.decoder = get_action_decoder(cfg.action_decoder, cfg.action_dim, encoder_dim,
                                          compute_dtype, fused_trunk=fused)
        self.num_proposal_networks = len(cfg.rendering.num_proposal_samples)
        for i in range(self.num_proposal_networks):
            self.add_module(f"proposal_networks_{i}",
                            DensityDecoderMlp(cfg.density_decoder, encoder_dim,
                                              compute_dtype, fused_trunk=fused))
        self.sampler_cfg = ProposalSamplerCfg(
            num_proposal_samples=tuple(cfg.rendering.num_proposal_samples),
            num_nerf_samples=cfg.rendering.num_nerf_samples,
            single_jitter=cfg.rendering.single_jitter,
            initial_spacing="uniform",
            use_pallas_pdf=cfg.rendering.use_pallas_pdf)

    @property
    def proposal_networks(self):
        return [getattr(self, f"proposal_networks_{i}")
                for i in range(self.num_proposal_networks)]

    def init_weights(self, generator: torch.Generator) -> "Model":
        """Seeded initialisation with the JAX package's distributions
        (models/initializers.py)."""
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        for net in self.proposal_networks:
            net.init_weights(generator)
        return self

    # -- building blocks ----------------------------------------------------

    @staticmethod
    def compute_ray_bundle(rendering_input: RenderingInput) -> RayBundle:
        ones = torch.ones_like(rendering_input.origins[..., :1])
        return RayBundle(origins=rendering_input.origins,
                         directions=rendering_input.directions,
                         nears=ones * rendering_input.z_near[:, None, None],
                         fars=ones * rendering_input.z_far[:, None, None])

    def compute_pixel_encoding(self, camera_input: CameraInput,
                               robot_input: RobotInput, train: bool = False) -> PixelEncoding:
        """Encode the context image (the encoder in training mode with
        `train`); in the pyramid layout the levels are packed here (K6) for
        the knot gathers."""
        features = self.encoder(camera_input.input_image, train)
        if self.compute_dtype is not None:
            features = features.to(self.compute_dtype)
        if isinstance(features, FeaturePyramid):
            features = pack_pyramid(features)
        return PixelEncoding(features=features, extrinsics=camera_input.ctxt_extrinsics,
                             intrinsics=camera_input.ctxt_intrinsics,
                             action=robot_input.robot_action)

    def attach_ray_features(self, pixel_encoding: PixelEncoding,
                            ray_bundle: RayBundle) -> PixelEncoding:
        """Swap the packed pyramid for per-ray knot textures once the rays are
        known (epipolar mode); shared by the proposal and NeRF stages."""
        from ..ops.epipolar import build_ray_knots

        if (self.cfg.rendering.pixel_feature_mode != "epipolar"
                or not isinstance(pixel_encoding.features, PackedPyramid)):
            return pixel_encoding
        knots = build_ray_knots(pixel_encoding.features, ray_bundle.origins,
                                ray_bundle.directions, ray_bundle.nears[..., 0],
                                ray_bundle.fars[..., 0], pixel_encoding.extrinsics,
                                pixel_encoding.intrinsics,
                                num_knots=tuple(self.cfg.rendering.epipolar_knots))
        return replace(pixel_encoding, features=knots)

    def compute_proposal(self, ray_bundle: RayBundle, pixel_encoding: PixelEncoding,
                         ctx: Optional[StepCtx] = None, stratified: bool = False):
        """Proposal sampling. As served (the defaults): deterministic bins, no
        anneal; in training: stratified, with the step's anneal, gate and
        draws from `ctx`."""
        ctx = ctx or StepCtx()
        density_fns = [(lambda xyz, net=net: net(xyz, pixel_encoding))
                       for net in self.proposal_networks]
        ray_samples, weights_list, ray_samples_list = proposal_sample(
            ray_bundle, density_fns, self.sampler_cfg, anneal=ctx.anneal,
            updated=ctx.updated, stratified=stratified, generator=ctx.generator,
            draws=ctx.draws)
        positions = ray_samples.get_positions()
        directions = ray_bundle.directions[..., None, :].expand(positions.shape)
        return ray_samples, positions, directions, weights_list, ray_samples_list

    @staticmethod
    def render_optical_flow(weights, ray_positions, scene_flow, trgt_extrinsics,
                            trgt_intrinsics):
        """Composite t0 and warped positions, project both, subtract."""
        warped = ray_positions + scene_flow
        pos = torch.sum(weights * ray_positions, dim=-2)
        pos_warped = torch.sum(weights * warped, dim=-2)
        uv = project_world_coords_to_camera(pos, trgt_extrinsics, trgt_intrinsics)
        uv_warped = project_world_coords_to_camera(pos_warped, trgt_extrinsics,
                                                   trgt_intrinsics)
        return uv_warped - uv, pos, pos_warped

    def _check_feature_mode(self):
        mode = self.cfg.rendering.pixel_feature_mode
        if mode not in ("exact", "epipolar"):
            raise ValueError(f"unknown pixel_feature_mode {mode!r}")

    # -- main forward --------------------------------------------------------

    def forward(self, model_input: ModelInput, train: bool = False,
                compute_vis_features: bool = False,
                ctx: Optional[StepCtx] = None) -> ModelOutput:
        """Render the input's rays. With `train`: the encoder in training
        mode (BatchNorm batch statistics, running buffers updated), stratified
        sampling from `ctx`, and the per-level weights and bin edges on the
        output for the losses."""
        self._check_feature_mode()
        camera_input = model_input.camera_input
        ray_bundle = self.compute_ray_bundle(model_input.rendering_input)
        pixel_encoding = self.compute_pixel_encoding(camera_input, model_input.robot_input,
                                                     train=train)
        return self.render_rays(pixel_encoding, ray_bundle, camera_input,
                                compute_vis_features, train=train, ctx=ctx)

    def render_rays(self, pixel_encoding: PixelEncoding, ray_bundle: RayBundle,
                    camera_input: CameraInput, compute_vis_features: bool = False,
                    train: bool = False, ctx: Optional[StepCtx] = None) -> ModelOutput:
        """Everything after the context encoding, for one bundle of rays (the
        chunked renderer calls this with the encoding computed once)."""
        pixel_encoding = self.attach_ray_features(pixel_encoding, ray_bundle)
        ray_samples, positions, directions, weights_list, ray_samples_list = (
            self.compute_proposal(ray_bundle, pixel_encoding, ctx, stratified=train))
        dec = self.decoder(positions, directions, pixel_encoding)
        weights = ray_samples.get_weights(dec.density)
        rgb = torch.sum(weights * dec.color, dim=-2)
        steps = (ray_samples.starts + ray_samples.ends) / 2
        depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + 1e-10)
        depth = torch.clamp(depth, steps.min(), steps.max())
        optical_flow, pos, pos_warped = self.render_optical_flow(
            weights, positions, dec.flow[..., :3], camera_input.trgt_extrinsics,
            camera_input.trgt_intrinsics)
        out = ModelOutput(rgb=rgb, depth=depth, optical_flow=optical_flow)
        if train:
            levels = ray_samples_list + [ray_samples]
            out.weights_list = tuple(weights_list + [weights])
            out.sdist_list = tuple(sdist_edges(rs) for rs in levels)
            out.tdist_list = tuple(tdist_edges(rs) for rs in levels)
        if compute_vis_features:
            out.action_features = torch.sum(weights * dec.action_features, dim=-2)
            out.ray_positions = pos
            out.ray_positions_warped = pos_warped
            out.weights = weights[..., 0]
            out.steps = steps[..., 0]
        return out

    # -- inference surface ---------------------------------------------------

    @torch.no_grad()
    def encode_image(self, camera_input: CameraInput, rendering_input: RenderingInput,
                     robot_input: RobotInput) -> ModelInferenceEncoding:
        """Evaluate density + Jacobian once for inverse dynamics. No gradient:
        the solvers differentiate only the action, downstream of this, so the
        kernels' autograd Functions save nothing here."""
        self._check_feature_mode()
        ray_bundle = self.compute_ray_bundle(rendering_input)
        pixel_encoding = self.compute_pixel_encoding(camera_input, robot_input)
        pixel_encoding = self.attach_ray_features(pixel_encoding, ray_bundle)
        ray_samples, positions, _, _, _ = self.compute_proposal(ray_bundle, pixel_encoding)
        density, action_features = self.decoder.encode_image(positions, pixel_encoding)
        return ModelInferenceEncoding(density=density, action_features=action_features,
                                      weights=ray_samples.get_weights(density),
                                      ray_samples_positions=positions)

    def infer_optical_flow(self, encoding: ModelInferenceEncoding,
                           camera_input: CameraInput,
                           robot_input: RobotInput) -> torch.Tensor:
        """Flow [B, R, 2] from a cached encoding: an einsum and a projection,
        differentiable with respect to the action."""
        action = robot_input.robot_action
        af = encoding.action_features
        j = af.reshape(*af.shape[:-1], action.shape[-1], -1)
        scene_flow = torch.einsum("brsat,ba->brst", j, action)
        optical_flow, _, _ = self.render_optical_flow(
            encoding.weights, encoding.ray_samples_positions, scene_flow[..., :3],
            camera_input.trgt_extrinsics, camera_input.trgt_intrinsics)
        return optical_flow
