"""The solve's composited flow (Model.composite_flow and
Model.composited_optical_flow; inference/action_opt.py), on the CPU.

The flow is linear in the action, so sum_s w_s (x_s + J_s a) = sum_s w_s x_s
+ (sum_s w_s J_s) a: the composite is read once a solve in place of the
per-sample Jacobian. Held here against the per-sample formula written out
(`per_sample_flow`: the einsum over the [B, R, S, A, 3] Jacobian, then
render_optical_flow, as infer_optical_flow computed the flow before) on
random encodings: the flow and its gradient with respect to the action, in
float64 and float32, with some rays and samples carrying no weight, at
several action sizes; both solvers against themselves on the per-sample
formula; and the `composites` counter. No JAX: the card's version of the
solve check (tests/test_torch_port_cuda.py) imports `per_sample_flow`.
"""

import math

import pytest
import torch

from neural_jacobian_field_torch.inference import action_opt
from neural_jacobian_field_torch.models.model import (
    CameraInput, Model, ModelInferenceEncoding, RobotInput)
from neural_jacobian_field_torch.utils import profiling

INTRINSICS = ((1.2, 0.0, 0.5), (0.0, 1.6, 0.5), (0.0, 0.0, 1.0))


def per_sample_flow(encoding, camera_input, action):
    """The flow [B, R, 2] of action [B, A] from the per-sample Jacobian:
    each sample's scene flow by an einsum, composited and projected with
    the warped positions (the plain reference of the composited flow)."""
    af = encoding.action_features
    j = af.reshape(*af.shape[:-1], action.shape[-1], -1)
    scene_flow = torch.einsum("brsat,ba->brst", j, action)
    flow, _, _ = Model.render_optical_flow(
        encoding.weights, encoding.ray_samples_positions, scene_flow[..., :3],
        camera_input.trgt_extrinsics, camera_input.trgt_intrinsics)
    return flow


def random_encoding(batch, rays, samples, action_dim, dtype=torch.float64, seed=0,
                    masked=False, device="cpu", jacobian_scale=0.05):
    """A cached encoding of points 1.5-3 in front of the identity camera
    (compositing weights that sum to at most 1 along a ray, Jacobian entries
    of `jacobian_scale`), and a target camera turned 10 degrees about the
    focus at z = 2. `masked`: a third of the rays and a quarter of the
    samples carry no weight."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=dtype)

    weights = torch.softmax(4.0 * rand(batch, rays, samples, 1), dim=-2) * (
        0.5 + 0.5 * rand(batch, rays, 1, 1))
    if masked:
        keep = (torch.arange(rays, device=device) % 3 > 0)[None, :, None, None] & \
            (torch.arange(samples, device=device) % 4 > 0)[None, None, :, None]
        weights = weights * keep
    positions = torch.cat([rand(batch, rays, samples, 2) - 0.5,
                           1.5 + 1.5 * rand(batch, rays, samples, 1)], dim=-1)
    jac = jacobian_scale * (2.0 * rand(batch, rays, samples, action_dim * 3) - 1.0)
    t = math.radians(10.0)
    trgt = torch.eye(4, device=device, dtype=dtype)
    trgt[0, 0], trgt[0, 2], trgt[2, 0], trgt[2, 2] = math.cos(t), math.sin(t), -math.sin(t), \
        math.cos(t)
    focus = torch.tensor([0.0, 0.0, 2.0], device=device, dtype=dtype)
    trgt[:3, 3] = focus - trgt[:3, :3] @ focus
    intr = torch.tensor(INTRINSICS, device=device, dtype=dtype)[None].expand(batch, 3, 3)
    cam = CameraInput(input_image=None, ctxt_extrinsics=None, ctxt_intrinsics=None,
                      trgt_extrinsics=trgt[None].expand(batch, 4, 4), trgt_intrinsics=intr)
    enc = ModelInferenceEncoding(density=None, action_features=jac, weights=weights,
                                 ray_samples_positions=positions)
    return enc, cam


@pytest.fixture(scope="module")
def model():
    """A small model: the solvers read its program cache, nothing else."""
    from _torch_port_common import torch_model_cfg

    return Model(torch_model_cfg())


def _action(batch, action_dim, dtype, seed=1, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.5 * torch.randn((batch, action_dim), generator=g, device=device, dtype=dtype)


def _cast(enc, cam, dtype):
    return (ModelInferenceEncoding(None, enc.action_features.to(dtype), enc.weights.to(dtype),
                                   enc.ray_samples_positions.to(dtype)),
            CameraInput(None, None, None, cam.trgt_extrinsics.to(dtype),
                        cam.trgt_intrinsics.to(dtype)))


# float64: summation order alone; float32: relative to a scale
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _assert_close(got, want, dtype, scale):
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * (1.0 if dtype == torch.float64 else scale), (err, scale)


def _max(x):
    return float(x.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("action_dim", [1, 8, 16])
def test_composited_flow_is_the_per_sample_flow(model, dtype, masked, action_dim):
    """infer_optical_flow (the composite, then the action's flow from it)
    against the per-sample formula, and one composite read by two actions;
    a ray with no weight has no flow. The flow is a difference of two
    projections, so float32 rounds it on the scale of the projected
    coordinates, in either formula: there within 1e-5 of that scale, and no
    further from the float64 flow than the per-sample formula is, twice
    over."""
    enc, cam = _cast(*random_encoding(2, 48, 24, action_dim, masked=masked), dtype)
    action = _action(2, action_dim, torch.float64)
    truth = per_sample_flow(*random_encoding(2, 48, 24, action_dim, masked=masked), action)
    action = action.to(dtype)
    composite = Model.composite_flow(enc, cam)
    assert composite.jacobian.shape == (2, 48, action_dim, 3)
    assert composite.jacobian.dtype == dtype
    model_flow = model.infer_optical_flow(enc, cam, RobotInput(action))
    assert torch.equal(model_flow, Model.composited_optical_flow(composite, action))
    for a in (action, -0.3 * action):
        want = per_sample_flow(enc, cam, a)
        got = Model.composited_optical_flow(composite, a)
        _assert_close(got, want, dtype, _max(composite.uv))
    if dtype == torch.float32:
        err = [_max(f.double() - truth) for f in (model_flow, per_sample_flow(enc, cam, action))]
        assert err[0] <= 2.0 * err[1], err
    if masked:
        assert torch.equal(model_flow[:, ::3], torch.zeros_like(model_flow[:, ::3]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("action_dim", [1, 8, 16])
def test_composited_flow_gradient_is_the_per_sample_gradient(dtype, masked, action_dim):
    """The gradient of a weighted sum of the flow with respect to the
    action, through the composite and through the per-sample formula
    (float32: relative to the gradient's largest entry)."""
    enc, cam = random_encoding(2, 48, 24, action_dim, dtype, masked=masked, seed=3)
    action = _action(2, action_dim, dtype, seed=4)
    cotangent = torch.randn((2, 48, 2), generator=torch.Generator().manual_seed(5),
                            dtype=dtype)
    composite = Model.composite_flow(enc, cam)
    grads = []
    for flow_of in (lambda a: per_sample_flow(enc, cam, a),
                    lambda a: Model.composited_optical_flow(composite, a)):
        a = action.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((flow_of(a) * cotangent).sum(), a)
        grads.append(g)
    _assert_close(grads[1], grads[0], dtype, _max(grads[0]))


def _per_sample_predictor(monkeypatch):
    """The solvers' predictor as it was: the per-sample formula on every
    call, no composite."""
    def predictor(model, action_features, weights, positions, trgt_extrinsics,
                  trgt_intrinsics):
        enc = ModelInferenceEncoding(None, action_features, weights, positions)
        cam = CameraInput(None, None, None, trgt_extrinsics, trgt_intrinsics)
        return lambda a: per_sample_flow(enc, cam, a)

    monkeypatch.setattr(action_opt, "_predictor", predictor)


# the tolerances of tests/test_torch_port_programs.py's solver tests
ADAM_TOL = 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_solvers_on_the_composite_are_the_per_sample_solvers(monkeypatch, model, masked):
    """The 100-step Adam solve (with a regulariser) and the least-squares
    solve toward a realisable flow (flows of 0.02-0.03 of the image), in
    float32 as served, on the composite and on the per-sample formula: the
    Adam solve's histories and best action within ADAM_TOL of scale, the
    least-squares action within ADAM_TOL relative; both near the action
    that made the flow."""
    enc, cam = _cast(*random_encoding(1, 64, 16, 8, masked=masked, seed=6,
                                      jacobian_scale=0.2), torch.float32)
    a_star = 0.2 * _action(1, 8, torch.float32, seed=7)
    target = per_sample_flow(enc, cam, a_star)
    rays = target.shape[1]
    mask = (torch.arange(rays) % 4 > 0).float()[None] if masked else None
    a0 = torch.full((1, 8), 1e-3)
    runs = []
    for per_sample in (False, True):
        with monkeypatch.context() as m:
            if per_sample:
                _per_sample_predictor(m)
            res = action_opt.optimize_actions(model, enc, cam, target, action0=a0,
                                              visible_mask=mask, num_iters=100,
                                              reg_multiplier=1e-4)
            lsq = action_opt.solve_actions_least_squares(model, enc, cam, target,
                                                         visible_mask=mask)
        runs.append((res, lsq))
    (got, got_lsq), (want, want_lsq) = runs
    for g, w in ((got.losses, want.losses), (got.actions, want.actions),
                 (got.action, want.action)):
        assert _max(g - w) <= ADAM_TOL * _max(w)
    assert abs(float(got.loss) - float(want.loss)) <= ADAM_TOL * float(want.losses[0])
    assert float((got_lsq - want_lsq).norm()) <= ADAM_TOL * float(want_lsq.norm())
    assert float((got_lsq - a_star).norm()) <= 0.05 * float(a_star.norm())
    assert float(got.loss) < 0.1 * float(got.losses[0])


def test_an_eager_solve_counts_one_composite(monkeypatch, model):
    """Each solver's program forms one composite a run; flows computed
    outside a program are counted nowhere."""
    from neural_jacobian_field_torch.inference.programs import ProgramCache

    monkeypatch.setattr(profiling, "_REG", profiling._Registry())
    monkeypatch.setattr(model, "programs", ProgramCache())  # its programs in this registry
    enc, cam = random_encoding(1, 32, 8, 8, torch.float32, seed=8)
    target = per_sample_flow(enc, cam, _action(1, 8, torch.float32, seed=9))
    model.infer_optical_flow(enc, cam, RobotInput(torch.zeros((1, 8))))
    assert profiling.counters() == {}
    action_opt.optimize_actions(model, enc, cam, target, action0=torch.zeros((1, 8)),
                                num_iters=5)
    action_opt.solve_actions_least_squares(model, enc, cam, target)
    got = {k.split("#")[0]: v["composites"] for k, v in profiling.counters().items()}
    assert got == {"solve": 1, "solve_least_squares": 1}
    (run,) = profiling.device_spans("solve")
    assert run["composites"] == 1
    assert "composite" not in run["self_ms"] and run["self_ms"]["render"] > 0
