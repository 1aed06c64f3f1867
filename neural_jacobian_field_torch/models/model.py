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

from ..inference.programs import ProgramCache
from ..ops.pixel_gather import (
    FeaturePyramid, PackedPyramid, feature_fields, features_from_fields, pack_pyramid)
from ..rendering.geometry import (
    homogenize_points, homogenize_vecs, project_world_coords_to_camera, transform_world2cam,
    z_divide)
from ..rendering.samplers import (
    ProposalSamplerCfg, RayBundle, proposal_anneal, proposal_sample, sdist_edges,
    tdist_edges)
from ..utils import profiling
from .decoders import (
    DECODERS,
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


def flagship_model_cfg(conv_impl: str = "pallas", **rendering_overrides) -> ModelCfg:
    """The flagship configuration (configurations/model/model_allegro.yaml +
    encoder/image_encoder_resnet.yaml, as bench.py builds it): BatchNorm
    ResNet-34 in pyramid layout with K9 convs, epipolar knots (64, 16, 8),
    fused K7-tz trunks, K5 resampling, jacobian_mlp decoder (ResnetFC 5 x 128,
    combine_layer 3), action_dim 8, 256 proposal + 256 NeRF samples. Run it
    with compute_dtype=torch.bfloat16. `pixel_feature_mode="exact"` selects
    the reference-numerics feature path (model_allegro.yaml's setting for
    ported-checkpoint evaluation): per-sample pyramid gathers with K1 on the
    coarse level, and K7 trunks that project the levels themselves.
    `conv_impl="pallas_fused"` adds the K10 BatchNorm-stats fold to the
    training-mode encoder (`NJF_CONV_IMPL=pallas_fused python bench.py`)."""
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
                                 feature_layout="pyramid", conv_impl=conv_impl),
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
    optical_flow: Optional[torch.Tensor]  # [B, R, 2]; None where not rendered
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
class FlowComposite:
    """A cached encoding composited along each ray, in the target camera's
    homogeneous pixel frame, for the flow of any action
    (`Model.composite_flow`). The flow is linear in the action up to the
    projection's divide by depth: with P = K [R | t]^-1 the target camera's
    map from world to homogeneous pixel coordinates, P (sum_s w_s (x_s +
    J_s a)) = P x + (P's linear part applied to J) a, where x = sum_s w_s
    x_s and J = sum_s w_s J_s. A solve reads these in place of the
    per-sample Jacobian."""

    jacobian: torch.Tensor  # [B, R, A, 3]: J, by P's linear part
    points: torch.Tensor  # [B, R, 3]: P x
    uv: torch.Tensor  # [B, R, 2]: x projected (the flow's origin)


@dataclass
class StepCtx:
    """Per-step sampler context (the JAX StepCtx): the proposal weights'
    anneal exponent (a float, or a 0-d tensor on the device), the proposal
    gate `updated` (a host-side bool), the stratified draws' source: a
    torch.Generator, or explicit per-level draws in [0, 1)
    (samplers.proposal_sample); and `render_flow`: whether the step renders
    optical flow and so evaluates the Jacobian trunk (a stage-1 step reads
    neither)."""

    anneal: Union[float, torch.Tensor] = 1.0
    updated: bool = True
    generator: Optional[torch.Generator] = None
    draws: Optional[Tuple[torch.Tensor, ...]] = None
    render_flow: bool = True


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


def step_anneal(count: torch.Tensor, cfg: RenderingCfg) -> torch.Tensor:
    """`step_schedules`' anneal exponent on the device, from the step count
    as a 0-d float32 tensor, in float32 as the JAX step computes it."""
    if not cfg.use_proposal_weight_anneal:
        return torch.ones_like(count)
    return proposal_anneal(count, cfg.proposal_weights_anneal_max_num_iters,
                           cfg.proposal_weights_anneal_slope)


class Model(nn.Module):
    """Encoder + proposal sampling + action decoder. `remat` recomputes the
    proposal nets' and the decoder's trunk activations in the backward
    (torch.utils.checkpoint, the JAX Model's remat): less memory for one
    more forward of those trunks."""

    def __init__(self, cfg: ModelCfg = ModelCfg(),
                 compute_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.cfg, self.compute_dtype, self.remat = cfg, compute_dtype, remat
        fused = cfg.rendering.use_fused_trunk
        self.encoder = EncoderResnet(cfg.encoder, compute_dtype)
        encoder_dim = EncoderResnet.output_dim(cfg.encoder)
        self.decoder = get_action_decoder(cfg.action_decoder, cfg.action_dim, encoder_dim,
                                          compute_dtype, fused_trunk=fused, remat=remat)
        self.num_proposal_networks = len(cfg.rendering.num_proposal_samples)
        for i in range(self.num_proposal_networks):
            self.add_module(f"proposal_networks_{i}",
                            DensityDecoderMlp(cfg.density_decoder, encoder_dim,
                                              compute_dtype, fused_trunk=fused, remat=remat))
        self.sampler_cfg = ProposalSamplerCfg(
            num_proposal_samples=tuple(cfg.rendering.num_proposal_samples),
            num_nerf_samples=cfg.rendering.num_nerf_samples,
            single_jitter=cfg.rendering.single_jitter,
            initial_spacing="uniform",
            use_pallas_pdf=cfg.rendering.use_pallas_pdf)
        # the serving entry points' and the train steps' captured programs
        # (inference/programs.py, training/train.py)
        self.programs = ProgramCache()

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

    def encode_features(self, image: torch.Tensor, train: bool = False):
        """The context image's features (the encoder in training mode with
        `train`); in the pyramid layout the levels are packed here (K6) for
        the row gathers: the epipolar mode's knots, or the exact mode's
        per-sample lookups."""
        with profiling.layer("encoder") as lay:
            features = self.encoder(image, train)
            if self.compute_dtype is not None:
                features = features.to(self.compute_dtype)
            features = lay.output(features)
        if isinstance(features, FeaturePyramid):
            with profiling.layer("features") as lay:
                features = lay.output(pack_pyramid(features))
        return features

    def features_program(self, image: torch.Tensor):
        """The serving encoder (`encode_features`) as a captured program for
        images like `image`; its outputs are the features' `feature_fields`."""
        return self.programs.get((Model.encode_features, self), (image,),
                                 lambda x: feature_fields(self.encode_features(x)),
                                 name="features")

    def compute_pixel_encoding(self, camera_input: CameraInput,
                               robot_input: RobotInput, train: bool = False) -> PixelEncoding:
        """Encode the context image (`encode_features`). Served (no `train`,
        no gradient) on the card, the encoder runs as a captured program."""
        image = camera_input.input_image
        if not train and not torch.is_grad_enabled() and self.programs.captures(image):
            features = features_from_fields(self.features_program(image)(image))
        else:
            features = self.encode_features(image, train)
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
        with profiling.layer("features") as lay:
            knots = build_ray_knots(pixel_encoding.features, ray_bundle.origins,
                                    ray_bundle.directions, ray_bundle.nears[..., 0],
                                    ray_bundle.fars[..., 0], pixel_encoding.extrinsics,
                                    pixel_encoding.intrinsics,
                                    num_knots=tuple(self.cfg.rendering.epipolar_knots))
            knots = lay.output(knots)
        return replace(pixel_encoding, features=knots)

    def compute_proposal(self, ray_bundle: RayBundle, pixel_encoding: PixelEncoding,
                         ctx: Optional[StepCtx] = None, stratified: bool = False):
        """Proposal sampling. As served (the defaults): deterministic bins, no
        anneal; in training: stratified, with the step's anneal, gate and
        draws from `ctx`."""
        ctx = ctx or StepCtx()
        density_fns = [(lambda xyz, net=net: net(xyz, pixel_encoding))
                       for net in self.proposal_networks]
        with profiling.layer("sampler") as lay:
            ray_samples, weights_list, ray_samples_list = proposal_sample(
                ray_bundle, density_fns, self.sampler_cfg, anneal=ctx.anneal,
                updated=ctx.updated, stratified=stratified, generator=ctx.generator,
                draws=ctx.draws)
            positions = ray_samples.get_positions()
            directions = ray_bundle.directions[..., None, :].expand(positions.shape)
            return lay.output((ray_samples, positions, directions, weights_list,
                               ray_samples_list))

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
        chunked renderer calls this with the encoding computed once). A
        step whose ctx renders no flow skips the Jacobian trunk: the output's
        optical_flow is None."""
        render_flow = compute_vis_features or ctx is None or ctx.render_flow
        pixel_encoding = self.attach_ray_features(pixel_encoding, ray_bundle)
        ray_samples, positions, directions, weights_list, ray_samples_list = (
            self.compute_proposal(ray_bundle, pixel_encoding, ctx, stratified=train))
        with profiling.layer("decoder") as lay:
            dec = lay.output(self.decoder(positions, directions, pixel_encoding,
                                          flow=render_flow, features=compute_vis_features))
        with profiling.layer("render") as lay:
            return lay.output(self._render(dec, ray_samples, positions, weights_list,
                                           ray_samples_list, camera_input, render_flow,
                                           compute_vis_features, train))

    def _render(self, dec, ray_samples, positions, weights_list, ray_samples_list,
                camera_input, render_flow, compute_vis_features, train) -> ModelOutput:
        """Compositing, depth and flow of the decoded samples (render_rays'
        last part)."""
        weights = ray_samples.get_weights(dec.density)
        rgb = torch.sum(weights * dec.color, dim=-2)
        steps = (ray_samples.starts + ray_samples.ends) / 2
        depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + 1e-10)
        depth = torch.clamp(depth, steps.min(), steps.max())
        optical_flow = pos = pos_warped = None
        if render_flow:
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
        """Evaluate density + Jacobian once for inverse dynamics (one captured
        program on the card). No gradient: the solvers differentiate only the
        action, downstream of this, so the kernels' autograd Functions save
        nothing here."""
        self._check_feature_mode()
        inputs = (camera_input.input_image, camera_input.ctxt_extrinsics,
                  camera_input.ctxt_intrinsics, robot_input.robot_action,
                  rendering_input.origins, rendering_input.directions,
                  rendering_input.z_near, rendering_input.z_far)
        with profiling.span("njf.encode", call=True):
            return ModelInferenceEncoding(*self.programs.run(
                (Model._encode_image, self), inputs, self._encode_image, name="encode"))

    def _encode_image(self, image, ctxt_extrinsics, ctxt_intrinsics, action, origins,
                      directions, z_near, z_far):
        ray_bundle = self.compute_ray_bundle(RenderingInput(origins, directions, z_near, z_far))
        pixel_encoding = PixelEncoding(features=self.encode_features(image),
                                       extrinsics=ctxt_extrinsics,
                                       intrinsics=ctxt_intrinsics, action=action)
        pixel_encoding = self.attach_ray_features(pixel_encoding, ray_bundle)
        ray_samples, positions, _, _, _ = self.compute_proposal(ray_bundle, pixel_encoding)
        with profiling.layer("decoder"):
            density, action_features = self.decoder.encode_image(positions, pixel_encoding)
        with profiling.layer("render"):
            weights = ray_samples.get_weights(density)
        return density, action_features, weights, positions

    @staticmethod
    def composite_flow(encoding: ModelInferenceEncoding,
                       camera_input: CameraInput) -> FlowComposite:
        """Composite the encoding's per-sample Jacobian and positions along
        each ray, and take both into the target camera's homogeneous pixel
        frame: one read of the Jacobian for any number of actions. The sums
        over the samples are elementwise products and reductions in the
        encoding's dtype (float32 as served), as render_optical_flow sums,
        so no TF32 matmul enters them; the camera maps are the projection's
        own einsums. Counted as the running program's composite
        (utils/profiling.py)."""
        profiling.composite()
        weights = encoding.weights
        jacobian = torch.sum(weights * encoding.action_features, dim=-2).unflatten(-1, (-1, 3))
        positions = torch.sum(weights * encoding.ray_samples_positions, dim=-2)
        ext, intr = camera_input.trgt_extrinsics, camera_input.trgt_intrinsics
        # as project_world_coords_to_camera maps points; vectors by the linear part
        cam = transform_world2cam(homogenize_points(positions), ext[:, None])
        points = torch.einsum("...ij,...j->...i", intr[:, None], cam[..., :3])
        cam = transform_world2cam(homogenize_vecs(jacobian), ext[:, None, None])
        jacobian = torch.einsum("...ij,...j->...i", intr[:, None, None], cam[..., :3])
        return FlowComposite(jacobian, points, z_divide(points)[..., :2])

    @staticmethod
    def composited_optical_flow(composite: FlowComposite, action: torch.Tensor) -> torch.Tensor:
        """Flow [B, R, 2] of action [B, A]: the composite's points moved by
        its Jacobian times the action, divided by depth, less the origin;
        differentiable with respect to the action."""
        xyw = composite.points + torch.sum(composite.jacobian * action[:, None, :, None], dim=-2)
        return z_divide(xyw)[..., :2] - composite.uv

    def infer_optical_flow(self, encoding: ModelInferenceEncoding,
                           camera_input: CameraInput,
                           robot_input: RobotInput) -> torch.Tensor:
        """Flow [B, R, 2] from a cached encoding, differentiable with respect
        to the action: the encoding composited (`composite_flow`), then the
        action's flow from the composite (`composited_optical_flow`)."""
        return self.composited_optical_flow(self.composite_flow(encoding, camera_input),
                                            robot_input.robot_action)


def make_model_cfg(action_decoder_name: str = "jacobian_transformer",
                   action_dim: int = 8, **overrides) -> ModelCfg:
    """A ModelCfg with the named action decoder's default config (the JAX
    make_model_cfg); other fields from `overrides`."""
    decoder_cfg_cls, _ = DECODERS[action_decoder_name]
    return ModelCfg(action_dim=action_dim, action_decoder=decoder_cfg_cls(), **overrides)
