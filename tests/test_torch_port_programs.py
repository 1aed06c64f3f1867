"""The serving entry points as captured programs (inference/programs.py), on
the CPU.

`CapturedProgram` and `ProgramCache` are held through fake capture backends:
their keying (input signature, the parameters' addresses), static buffers,
returned copies and launch accounting. `EagerReplay` stands in for a CUDA
graph: its capture runs the function once on the static inputs, and each
replay runs it again there and copies the results into the captured outputs,
so the programs' plumbing (static buffers, the encoder's outputs read in
place by the chunk program, output slices, inputs kept between chunks) runs
on the CPU. Through it every entry point equals the eager one bit for bit,
and the static-buffer render and the tensor-op Adam solve are held against
the JAX package. The card cases are in tests/test_torch_port_cuda.py.
"""

import contextlib
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from torch import nn

from _torch_port_common import ACTION_DIM, scene_arrays, torch_model_cfg
from neural_jacobian_field_torch.inference.programs import CapturedProgram, ProgramCache
from neural_jacobian_field_torch.models.model import (
    CameraInput, Model, RenderingInput, RobotInput)
from neural_jacobian_field_torch.ops import kernels as K
from neural_jacobian_field_torch.ops.pixel_gather import feature_fields
from test_torch_port_model import (  # noqa: F401 (fixtures)
    FIELD_TOL, _close, _port_encoding, _realisable_target, encodings, setup)


class CountingBackend:
    """A capture backend that runs fn at warm-up and capture and does
    nothing at replay; it counts both."""

    def __init__(self):
        self.captured = self.replayed = 0

    @staticmethod
    def captures(device):
        return True

    @staticmethod
    def warm_up(fn, inputs):
        for _ in range(2):
            fn(*inputs)

    def capture(self, fn, inputs):
        self.captured += 1
        return "graph", fn(*inputs)

    def replay(self, graph):
        assert graph == "graph"
        self.replayed += 1


class EagerReplay:
    """A capture backend on the CPU: a replay runs fn again on the static
    inputs and copies its results into the outputs captured."""

    @staticmethod
    def captures(device):
        return True

    @staticmethod
    def warm_up(fn, inputs):
        for _ in range(2):
            fn(*inputs)

    @staticmethod
    def capture(fn, inputs):
        outputs = fn(*inputs)
        return (fn, inputs, outputs), outputs

    @staticmethod
    def replay(handle):
        fn, inputs, outputs = handle
        for out, new in zip(outputs, fn(*inputs)):
            if isinstance(out, torch.Tensor):
                out.copy_(new)


@contextlib.contextmanager
def programs_on_cpu(model):
    """The model's entry points through EagerReplay programs."""
    saved = model.programs
    model.programs = ProgramCache(EagerReplay())
    try:
        yield model.programs
    finally:
        model.programs = saved


@pytest.fixture
def counts():
    K.reset_launch_counts()
    yield
    K.reset_launch_counts()


def _fake_kernels(x):
    """Stands in for a function of two kernels: K6-fwd once, K9-fwd twice
    (one of them its legacy kernel)."""
    K.pack_2x2_flat.launches += 1
    K.conv3x3_s1.launches += 2
    K.conv3x3_s1.legacy_launches += 1
    return x * 2.0, "aux"


# ------------------------------------------------------------ CapturedProgram

@pytest.mark.parametrize("replays", [1, 5])
def test_replays_add_the_captured_launches(counts, replays):
    backend = CountingBackend()
    prog = CapturedProgram(_fake_kernels, (torch.ones(3),), backend)
    # the warm-up calls launched (twice); the capture launched nothing
    assert (K.pack_2x2_flat.launches, K.conv3x3_s1.launches,
            K.conv3x3_s1.legacy_launches) == (2, 4, 2)
    assert prog.launches["K6-fwd"] == (1, 0) and prog.launches["K9-fwd"] == (2, 1)
    assert all(v == (0, 0) for k, v in prog.launches.items() if k not in ("K6-fwd", "K9-fwd"))
    for _ in range(replays):
        prog(torch.ones(3))
    assert backend.captured == 1 and backend.replayed == replays
    assert K.pack_2x2_flat.launches == 2 + replays
    assert K.conv3x3_s1.launches == 4 + 2 * replays
    assert K.conv3x3_s1.legacy_launches == 2 + replays
    assert sum(K.launch_counts().values()) == 6 + 3 * replays


def test_failed_capture_raises_and_counts_nothing(counts):
    class Refuses(CountingBackend):
        def capture(self, fn, inputs):
            fn(*inputs)
            raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        CapturedProgram(_fake_kernels, (torch.ones(3),), Refuses())
    assert K.pack_2x2_flat.launches == 2 and K.conv3x3_s1.launches == 4


def test_no_garbage_collection_during_a_capture():
    """Cyclic garbage (a dropped model and its programs refer to each other)
    is collected before a capture, and no collection runs inside it: a CUDA
    graph freed mid-capture invalidates the capture. Collection is on again
    after, also where the capture raised."""
    import gc
    import weakref

    class Cycle:
        pass

    seen = []

    class Records(CountingBackend):
        def capture(self, fn, inputs):
            seen.append((gc.isenabled(), ref() is None))
            return super().capture(fn, inputs)

    garbage = Cycle()
    garbage.me = garbage
    ref = weakref.ref(garbage)
    del garbage
    assert gc.isenabled()
    CapturedProgram(lambda x: (x + 1,), (torch.ones(2),), Records())
    assert seen == [(False, True)] and gc.isenabled()

    class Fails(CountingBackend):
        def capture(self, fn, inputs):
            raise RuntimeError("capture invalidated")

    with pytest.raises(RuntimeError):
        CapturedProgram(lambda x: (x + 1,), (torch.ones(2),), Fails())
    assert gc.isenabled()


def test_program_buffers_copies_and_destinations():
    prog = CapturedProgram(lambda x, y: (x + y, 7), (torch.zeros(2), torch.ones(2)),
                           EagerReplay())
    a = prog(torch.tensor([1.0, 2.0]), torch.tensor([10.0, 20.0]))
    b = prog(torch.tensor([3.0, 4.0]), None)  # None: y stays [10, 20]
    assert torch.equal(a[0], torch.tensor([11.0, 22.0])) and a[1] == 7
    assert torch.equal(b[0], torch.tensor([13.0, 24.0]))
    # a result the caller holds is a copy: later replays leave it alone
    assert a[0] is not prog.outputs[0] and torch.equal(a[0], torch.tensor([11.0, 22.0]))
    dst = torch.zeros(4)
    prog(torch.zeros(2), torch.zeros(2) + 5, out=[dst[1:3]])
    assert torch.equal(dst, torch.tensor([0.0, 5.0, 5.0, 0.0]))
    # the caller's inputs were copied in, not taken over
    x = torch.ones(2)
    prog(x, x)
    assert prog.inputs[0] is not x and prog.inputs[0].data_ptr() != x.data_ptr()


# ------------------------------------------------------------- ProgramCache

def test_cache_keys_on_signature_and_parameter_addresses(counts):
    backend = CountingBackend()
    cache = ProgramCache(backend)
    lin = nn.Linear(3, 2)

    def fn(x):
        return (lin(x),)

    def get(x):
        return cache.get(("fn", lin), (x,), fn)

    p = get(torch.ones(4, 3))
    assert get(torch.zeros(4, 3)) is p and backend.captured == 1
    with torch.no_grad():  # weights loaded in place: the same program reads them
        lin.weight.copy_(torch.randn(2, 3))
    assert get(torch.ones(4, 3)) is p and backend.captured == 1
    # another shape, dtype or key: another program beside it
    q = get(torch.ones(5, 3))
    assert q is not p and backend.captured == 2 and len(cache) == 2
    assert cache.get(("other", lin), (torch.ones(4, 3),), fn) is not p and len(cache) == 3
    # weights reassigned: captured again, and the superseded program dropped
    lin.weight = nn.Parameter(torch.randn(2, 3))
    p2 = get(torch.ones(4, 3))
    assert p2 is not p and backend.captured == 4 and len(cache) == 3
    assert get(torch.ones(4, 3)) is p2 and p2 in list(cache) and p not in list(cache)
    # a resident tensor read in place (the encoder's outputs) keys the same way
    r1, r2 = torch.ones(2), torch.ones(2)
    rp = cache.get(("r",), (torch.ones(1),), lambda x: (x,), resident=[r1])
    assert cache.get(("r",), (torch.ones(1),), lambda x: (x,), resident=[r1]) is rp
    assert cache.get(("r",), (torch.ones(1),), lambda x: (x,), resident=[r2]) is not rp


def test_cache_runs_eagerly_on_the_cpu_and_inside_eager():
    calls = []

    def fn(x):
        calls.append(1)
        return (x + 1,)

    x = torch.zeros(2)
    default = ProgramCache()
    assert not default.captures(x)
    assert torch.equal(default.run(("f",), (x,), fn)[0], x + 1) and len(default) == 0
    cache = ProgramCache(EagerReplay())
    assert cache.captures(x)
    with cache.eager():
        assert not cache.captures(x)
        cache.run(("f",), (x,), fn)
    assert cache.captures(x) and len(cache) == 0
    cache.run(("f",), (x,), fn)
    assert len(cache) == 1


# ------------------------------------------------ entry points, both modes

def _seeded_model(mode):
    """The small flagship-shaped model (tests/_torch_port_common.py) in the
    given feature mode, float32, seeded weights: the Jacobian head at the
    density head's scale, BatchNorm statistics not the identity."""
    cfg = torch_model_cfg()
    cfg = replace(cfg, rendering=replace(cfg.rendering, pixel_feature_mode=mode))
    g = torch.Generator().manual_seed(3)
    model = Model(cfg).init_weights(g)
    head = model.decoder.jacobian_head
    head.near_zero_init = False
    head.init_weights(g)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def _scene(seed=0, rays=24, deg=10.0):
    from _torch_port_common import look_at_offset

    a = {k: torch.from_numpy(v) for k, v in scene_arrays(seed, rays).items()}
    cam = CameraInput(input_image=a["image"], ctxt_extrinsics=a["ctxt"],
                      ctxt_intrinsics=a["intr"],
                      trgt_extrinsics=torch.from_numpy(look_at_offset(deg)[None]),
                      trgt_intrinsics=a["intr"])
    ri = RenderingInput(origins=a["origins"], directions=a["dirs"], z_near=a["near"],
                        z_far=a["far"])
    return cam, ri, RobotInput(a["action"])


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_static_buffer_render_is_the_eager_render(mode):
    """Three 16-ray chunks of a 6x8 view: the encoder program's outputs read
    in place, the cameras kept in the chunk program's buffers after chunk 0,
    outputs copied into slices; then a second render with a shifted target
    camera, a new image and a new action through the same programs."""
    from neural_jacobian_field_torch.inference.render import render_camera

    model = _seeded_model(mode)
    cam, _, robot = _scene()
    cam2, _, _ = _scene(seed=1, deg=14.0)
    robot2 = RobotInput(robot.robot_action.flip(-1))
    want = [render_camera(model, c, r, 0.5, 4.0, 6, 8, patch_size=16)
            for c, r in ((cam, robot), (cam2, robot2))]
    with programs_on_cpu(model) as cache:
        got = [render_camera(model, c, r, 0.5, 4.0, 6, 8, patch_size=16)
               for c, r in ((cam, robot), (cam2, robot2))]
        assert len(cache) == 2  # the encoder and one chunk, captured once
    for g, w in zip(got, want):
        _equal(tuple(vars(g).values()), tuple(vars(w).values()))
    assert not torch.equal(got[0].rgb, got[1].rgb)


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_captured_encoders_and_solvers_are_the_eager_ones(mode):
    """compute_pixel_encoding, encode_image, the 100-step Adam solve (with a
    mask and a regulariser) and the least-squares solve through programs,
    each called twice on new inputs, equal their eager versions bit for
    bit."""
    from neural_jacobian_field_torch.inference.action_opt import (
        optimize_actions, solve_actions_least_squares)

    model = _seeded_model(mode)
    runs = []
    for cache in (contextlib.nullcontext(), programs_on_cpu(model)):
        with cache:
            out = []
            for seed in (0, 1):
                cam, ri, robot = _scene(seed)
                with torch.no_grad():
                    pe = model.compute_pixel_encoding(cam, robot)
                out += list(feature_fields(pe.features)[:3])
                enc = model.encode_image(cam, ri, robot)
                out += [enc.density, enc.action_features, enc.weights,
                        enc.ray_samples_positions]
                target = model.infer_optical_flow(enc, cam, RobotInput(
                    0.05 * robot.robot_action)).detach()
                mask = (torch.arange(ri.origins.shape[1]) % 3 > 0).float()[None]
                a0 = torch.full((1, ACTION_DIM), 1e-3 * (seed + 1))
                res = optimize_actions(model, enc, cam, target, action0=a0, num_iters=100,
                                       visible_mask=mask, reg_multiplier=1e-3)
                out += list(res)
                out.append(solve_actions_least_squares(model, enc, cam, target))
            runs.append(out)
    _equal(runs[1], runs[0])


# ------------------------------------------------------- against JAX

def test_static_buffer_render_matches_jax(setup):
    """The programs' render of the JAX tests' model against JAX's
    patch_render, with test_render_camera_matches_jax's tolerances."""
    from neural_jacobian_field_tpu.inference.render import render_camera as j_render
    from neural_jacobian_field_torch.inference.render import render_camera

    s = setup
    want = j_render(s["jmodel"], s["variables"], s["jcam"], s["jrobot"], 0.5, 4.0,
                    height=6, width=8, patch_size=16)
    with programs_on_cpu(s["tmodel"]):
        got = render_camera(s["tmodel"], s["tcam"], s["trobot"], 0.5, 4.0, height=6, width=8,
                            patch_size=16)
    _close(got.rgb, want.rgb, tol=FIELD_TOL)
    _close(got.depth_raw, want.depth_raw, rel=True, tol=FIELD_TOL)
    _close(got.ray_positions, want.ray_positions, rel=True, tol=FIELD_TOL)
    _close(got.action_features, want.action_features, rel=True, tol=FIELD_TOL)
    _close(got.weights, want.weights, tol=FIELD_TOL)
    g, w = got.flow_raw.numpy(), np.asarray(want.flow_raw)
    ok = np.abs(w).max(-1) < 5.0  # well-conditioned projections, as there
    assert ok.mean() > 0.9
    _close(g[ok], w[ok], rel=True, tol=FIELD_TOL)


ADAM_TOL = 1e-5


@pytest.mark.parametrize("masked,reg", [(False, 0.0), (True, 1e-2)])
def test_tensor_op_adam_matches_optax(setup, encodings, masked, reg):
    """The tensor-op Adam (optax's formula) against JAX's optimize_actions on
    the same float32 encoding, target, mask and action0: both compute the
    same operations, bias corrections in float32 included, so the residue
    is float32 reordering (the flow's sums, its gradient) carried through
    100 steps (measured 4.7e-6): ADAM_TOL relative to scale on the loss
    history, the action history and the best action; the best loss, near 0,
    on the scale of the first loss."""
    from neural_jacobian_field_tpu.inference.action_opt import optimize_actions as j_opt
    from neural_jacobian_field_torch.inference.action_opt import optimize_actions

    s = setup
    jenc, _ = encodings
    target = _realisable_target(s, jenc, np.array([[0.05, -0.04, 0.02, 0.03]], np.float32))
    rays = np.asarray(target).shape[1]
    mask = (np.arange(rays) % 4 > 0).astype(np.float32)[None] if masked else None
    key = jax.random.PRNGKey(5)
    action0 = np.array(jax.random.normal(key, (1, ACTION_DIM)) * 0.001)
    want = j_opt(s["jmodel"], s["variables"], jenc, s["jcam"], target, key,
                 visible_mask=None if mask is None else jax.numpy.asarray(mask),
                 num_iters=100, reg_multiplier=reg)
    with programs_on_cpu(s["tmodel"]):
        got = optimize_actions(s["tmodel"], _port_encoding(jenc), s["tcam"],
                               torch.from_numpy(np.array(target)),
                               action0=torch.from_numpy(action0),
                               visible_mask=None if mask is None else torch.from_numpy(mask),
                               num_iters=100, reg_multiplier=reg)
    _close(got.losses, want.losses, tol=ADAM_TOL, rel=True)
    _close(got.actions, want.actions, tol=ADAM_TOL, rel=True)
    _close(got.action, want.action, tol=ADAM_TOL, rel=True)
    assert abs(float(got.loss) - float(want.loss)) <= ADAM_TOL * float(want.losses[0])
    assert float(got.loss) < 0.1 * float(got.losses[0])


@pytest.mark.parametrize("masked", [False, True])
def test_least_squares_solve_ex_is_the_checked_solve(setup, encodings, masked):
    """solve_ex without the singular-matrix check gives the action that
    torch.linalg.solve gave on the same normal equations, bit for bit."""
    from neural_jacobian_field_torch.inference.action_opt import solve_actions_least_squares

    s = setup
    jenc, _ = encodings
    target = torch.from_numpy(np.array(_realisable_target(
        s, jenc, np.array([[0.03, -0.02, 0.01, 0.025]], np.float32))))
    enc = _port_encoding(jenc)
    mask = (torch.arange(target.shape[1]) % 3 > 0).float()[None] if masked else None
    got = solve_actions_least_squares(s["tmodel"], enc, s["tcam"], target, visible_mask=mask)

    # the solve as it was written before (torch.linalg.solve)
    def predict(a):
        return s["tmodel"].infer_optical_flow(enc, s["tcam"], RobotInput(a))

    a0 = torch.zeros((1, ACTION_DIM))
    with torch.no_grad():
        f0 = predict(a0)
    jac = torch.einsum("brcba->brca", torch.func.jacfwd(predict)(a0))
    resid = target - f0
    if mask is not None:
        jac, resid = jac * mask[..., None, None], resid * mask[..., None]
    jtj = torch.einsum("brca,brcd->bad", jac, jac)
    jtr = torch.einsum("brca,brc->ba", jac, resid)
    scale = torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1)[..., None, None] / ACTION_DIM
    jtj = jtj + (1e-4 * scale + 1e-20) * torch.eye(ACTION_DIM)
    want = torch.linalg.solve(jtj, jtr[..., None])[..., 0]
    assert torch.equal(got, want)
    with programs_on_cpu(s["tmodel"]):
        assert torch.equal(solve_actions_least_squares(s["tmodel"], enc, s["tcam"], target,
                                                       visible_mask=mask), want)


def test_unchecked_inverse_is_the_inverse():
    from neural_jacobian_field_torch.rendering.geometry import inverse

    a = torch.randn(3, 4, 4, generator=torch.Generator().manual_seed(0)) + 3 * torch.eye(4)
    assert torch.equal(inverse(a), torch.linalg.inv(a))
    # a singular matrix: no error, as jnp.linalg.inv raises none
    with pytest.raises(RuntimeError):
        torch.linalg.inv(torch.zeros(4, 4))
    assert inverse(torch.zeros(4, 4)).shape == (4, 4)


def test_encoder_program_takes_the_concat_map():
    """The concat layout (one map, not yet gathered from in the port) goes
    through the encoder program as it does eagerly."""
    cfg = torch_model_cfg()
    model = Model(replace(cfg, encoder=replace(cfg.encoder, feature_layout="concat")))
    model.init_weights(torch.Generator().manual_seed(4)).eval()
    cam, _, robot = _scene()
    with torch.no_grad():
        want = model.compute_pixel_encoding(cam, robot).features
        with programs_on_cpu(model):
            got = model.compute_pixel_encoding(cam, robot).features
    assert isinstance(want, torch.Tensor) and torch.equal(got, want)
