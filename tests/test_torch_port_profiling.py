"""Spans, layer marks and counters (utils/profiling.py), on the CPU.

The small flagship-shaped model of tests/_torch_port_common.py runs its
train program and its solve eagerly (the CPU path of inference/programs.py),
where a mark reads the host clock: the host spans' tree and call
identifiers, the device spans' tree and self-time arithmetic, when host
spans are recorded, the NJF_SPANS switch, and the benchmark's readers of
the registry (portbench/metrics/) on a registry made by hand. The card's
cases (marks captured into a CUDA graph) are in tests/test_torch_port_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_common import INTRINSICS, IMAGE_HW, look_at_offset, torch_model_cfg
from neural_jacobian_field_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
RAYS = 16


@pytest.fixture(autouse=True)
def fresh_registry(monkeypatch):
    """Each test on a registry of its own, one torch thread."""
    monkeypatch.setattr(profiling, "_REG", profiling._Registry())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state():
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    g = torch.Generator().manual_seed(3)
    model = Model(torch_model_cfg()).init_weights(g)
    return create_train_state(model, TrainCfg(lr=1e-3, warm_up_steps=4, rays_per_batch=RAYS))


def _batch(k=2, b=2, seed=11):
    """k stacked batches of b images."""
    from neural_jacobian_field_torch.training import RawBatch

    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW

    def stack(a):
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(a, (k, *a.shape))))

    def f32(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    return RawBatch(
        ctxt_rgb=torch.from_numpy(f32(k, b, h, w, 3)),
        ctxt_extrinsics=stack(np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4))),
        ctxt_intrinsics=stack(np.broadcast_to(INTRINSICS, (b, 3, 3))),
        robot_action=torch.from_numpy(rng.normal(size=(k, b, 4)).astype(np.float32)),
        trgt_rgb=torch.from_numpy(f32(k, b, h, w, 3)),
        trgt_depth=torch.from_numpy(1.0 + 2.5 * f32(k, b, h, w, 1)),
        trgt_extrinsics=stack(np.stack([look_at_offset(10.0), look_at_offset(-8.0)])),
        trgt_intrinsics=stack(np.broadcast_to(INTRINSICS, (b, 3, 3))),
        near=torch.full((k, b), 0.5), far=torch.full((k, b), 4.0))


def _train_call(state):
    from neural_jacobian_field_torch.training import make_multi_train_step

    step = make_multi_train_step(state.model, state.cfg, 2, static_schedule=(False, True))
    return step(state, _batch(), generator=torch.Generator().manual_seed(5))


def _solve(model, num_iters=12):
    """encode_image on a seeded frame, then optimize_actions toward a flow."""
    from neural_jacobian_field_torch.inference.action_opt import optimize_actions
    from neural_jacobian_field_torch.models.model import CameraInput, RenderingInput, RobotInput

    g = torch.Generator().manual_seed(7)
    h, w = IMAGE_HW
    eye = torch.eye(4)[None]
    intr = torch.from_numpy(INTRINSICS)[None]
    trgt = torch.from_numpy(look_at_offset(10.0))[None]
    cam = CameraInput(torch.rand((1, h, w, 3), generator=g), eye, intr, trgt, intr)
    d = torch.randn((1, RAYS, 3), generator=g)
    d[..., 2] = 2.0
    rendering = RenderingInput(torch.zeros((1, RAYS, 3)), d / d.norm(dim=-1, keepdim=True),
                               torch.full((1,), 0.5), torch.full((1,), 4.0))
    robot = RobotInput(torch.zeros((1, 4)))
    enc = model.encode_image(cam, rendering, robot)
    return optimize_actions(model, enc, cam, 0.01 * torch.randn((1, RAYS, 2), generator=g),
                            action0=torch.zeros((1, 4)), num_iters=num_iters)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def test_train_call_gives_the_span_tree_in_order():
    """One eager 2-step train call inside collect(): the entry span, its
    parts in order, the program's two steps with their layers in order, all
    of one call; the device spans of the program's run: the same layers, one
    tree, two steps."""
    state = _state()
    with profiling.collect():
        _train_call(state)
    spans = profiling.host_spans()
    assert spans[0].name == "njf.train.call" and spans[0].parent == -1
    assert spans[0].attrs == {"steps": 2}
    assert {s.call for s in spans} == {spans[0].call} and spans[0].call > 0
    assert _children(spans, 0) == ["njf.train.split", "njf.train.randomness",
                                   "njf.train.stack", "njf.train.program", "njf.train.advance"]
    program = [i for i, s in enumerate(spans) if s.name == "njf.train.program"][0]
    assert _children(spans, program) == ["njf.step", "njf.step"]
    first = [i for i, s in enumerate(spans) if s.name == "njf.step"][0]
    assert _children(spans, first) == [
        "njf.encoder", "njf.features", "njf.features", "njf.sampler", "njf.decoder",
        "njf.render", "njf.loss", "njf.optimizer"]
    assert all(s.end_ns >= s.start_ns and (s.parent < 0 or spans[s.parent].start_ns <= s.start_ns)
               for s in spans)

    (run,) = profiling.device_spans()
    assert run["program"] == "train" and run["steps"] == 2 and run["call"] == spans[0].call
    tree = run["spans"]
    assert tree[0]["name"] == "train" and tree[0]["parent"] == -1
    steps = [i for i, s in enumerate(tree) if s["name"] == "step"]
    assert len(steps) == 2 and all(tree[i]["parent"] == 0 for i in steps)
    forward = [s["name"] for s in tree if s["parent"] == steps[0]]
    assert forward[:6] == ["encoder", "features", "features", "sampler", "decoder", "render"]
    assert forward[6] == "loss" and forward[-1] == "optimizer"
    # the backward enters the layers again, the loss first (a frozen step:
    # no sampler backward)
    assert forward[7:9] == ["loss", "render"] and "encoder" in forward[9:-1]
    assert all(tree[s["parent"]]["depth"] == s["depth"] - 1 for s in tree[1:])
    assert set(run["self_ms"]) <= set(profiling.LAYERS) | {profiling.UNATTRIBUTED}


def test_self_times_sum_to_the_root():
    """Over a train call and an encode and solve: the layers' self times
    (and the span tree's) sum to the run's device time, and each step's
    too; every span lies inside its parent."""
    state = _state()
    _train_call(state)
    with torch.no_grad():
        _solve(state.model)
    runs = profiling.device_spans()
    assert [r["program"] for r in runs] == ["train", "encode", "solve"]
    for run in runs:
        total = run["device_ms"]
        assert total > 0
        assert sum(run["self_ms"].values()) == pytest.approx(total, rel=1e-9)
        assert sum(s["self"] for s in run["spans"]) == pytest.approx(total, rel=1e-9)
        assert run["spans"][0]["end"] == pytest.approx(total)
        for s in run["spans"][1:]:
            p = run["spans"][s["parent"]]
            assert p["start"] <= s["start"] <= s["end"] <= p["end"]
            assert s["self"] <= s["end"] - s["start"] + 1e-9
    train = runs[0]
    assert sum(sum(t.values()) for t in train["per_step"]) <= train["device_ms"]


def test_solve_marks_its_phases_and_one_call():
    """The encode and the solve each start a call; the solve's composite,
    before its iterations, is render; its marked iterations give render,
    loss and optimizer, the others are shared among them (estimated), and
    nothing is left as the pseudo-layer or the part."""
    from neural_jacobian_field_torch.inference import action_opt

    state = _state()
    with profiling.collect():
        _solve(state.model, num_iters=2 * action_opt.MARK_EVERY + 3)
    spans = profiling.host_spans()
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["njf.encode", "njf.solve"]
    assert roots[0].call != roots[1].call
    solve = spans.index(roots[1])
    names = _children(spans, solve)
    assert names[:4] == ["njf.render", "njf.render", "njf.loss", "njf.optimizer"]
    assert _children(spans, solve + 1) == ["njf.composite"]
    # the composite, 3 marked iterations and the final score
    assert names.count("njf.render") == 1 + 3 + 1
    encode, run = profiling.device_spans()
    assert encode["program"] == "encode" and encode["call"] == roots[0].call
    assert set(encode["self_ms"]) >= {"encoder", "features", "sampler", "field", "decoder",
                                      "render"}
    assert run["program"] == "solve" and run["call"] == roots[1].call
    assert set(run["self_ms"]) <= {"render", "loss", "optimizer", profiling.UNATTRIBUTED}
    assert 0 < run["estimated_ms"] < run["device_ms"]
    tree = [s["name"] for s in run["spans"] if s["depth"] == 1]
    assert tree[:4] == ["render", "loss", "render", "optimizer"]  # the backward between
    assert [s["name"] for s in run["spans"] if s["depth"] == 2] == ["composite"]
    assert tree.count("iterations") == 3
    assert run["composites"] == 1


def test_host_spans_are_recorded_only_while_recording():
    """Outside a profiler and collect() a span records nothing (unless
    `always`); inside collect() it reaches the registry; inside a
    torch.profiler session it reaches the registry and the profiler's
    trace."""
    with profiling.span("njf.a"):
        pass
    assert profiling.host_spans() == []
    with profiling.span("njf.b", always=True):
        pass
    assert [s.name for s in profiling.host_spans()] == ["njf.b"]
    with profiling.collect():
        with profiling.span("njf.c", call=True):
            with profiling.span("njf.d"):
                pass
    with profiling.span("njf.e"):
        pass
    got = profiling.host_spans()
    assert [s.name for s in got] == ["njf.b", "njf.c", "njf.d"]
    assert got[2].parent == 1 and got[2].call == got[1].call != got[0].call
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("njf.f"):
            torch.ones(4).sum()
    assert profiling.host_spans("njf.f")
    assert "njf.f" in {e.name for e in prof.events()}


def test_spans_off_record_nothing_and_mark_nothing(monkeypatch):
    """With the switch off no span is recorded, always or in collect(), and
    a program's run holds no mark; the counters still count. NJF_SPANS=0 in
    the environment turns the switch off at import."""
    monkeypatch.setattr(profiling, "ENABLED", False)
    state = _state()
    with profiling.collect():
        with profiling.span("njf.x", always=True):
            _train_call(state)
    assert profiling.host_spans() == []
    assert profiling.device_spans() == []
    assert all(p.run is None for p in profiling._REG.programs.values())
    env = dict(os.environ, NJF_SPANS="0")
    out = subprocess.run([sys.executable, "-c",
                          "from neural_jacobian_field_torch.utils import profiling as p; "
                          "print(p.ENABLED)"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr


def test_captures_and_replays_are_counted():
    """A program's captures (its first, and each after its weights moved)
    and replays, by program, through a capture backend that replays
    nothing; each capture is a span recorded without collect()."""
    from neural_jacobian_field_torch.inference.programs import ProgramCache
    from test_torch_port_programs import CountingBackend

    cache = ProgramCache(CountingBackend())
    lin = torch.nn.Linear(3, 3)
    x = torch.ones(2, 3)
    for _ in range(3):
        cache.run((torch.nn.Linear.forward, lin), (x,), lambda t: (lin(t),), name="lin")
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())  # moved: captured again
    cache.run((torch.nn.Linear.forward, lin), (x,), lambda t: (lin(t),), name="lin")
    (name, counts), = profiling.counters().items()
    assert name.startswith("lin#") and counts == {"captures": 2, "replays": 4, "composites": 0,
                                                   "pixel_gathers": 0, "attn_fused_points": 0}
    captures = profiling.host_spans("njf.program.capture")
    assert len(captures) == 2
    spans = profiling.host_spans()
    first = spans.index(captures[0])
    assert _children(spans, first) == ["njf.program.warm_up", "njf.program.graph"]


# ------------------------------------------------------------ the readers

def _reader_cell(kind):
    import types

    return types.SimpleNamespace(kind=kind, traffic={"kind": kind})


def _run(name, marks, steps=False):
    """A program's last run made by hand: `marks` is [(path, ms)], each the
    time to the next; a closing mark at the root ends it."""
    pid = profiling.new_program(name)
    run = profiling._Run(torch.device("cpu"), None)
    t, step = 0, -1
    for path, ms in marks:
        if steps and path == ("step",):
            step += 1
        run.labels.append((path, step))
        run.host_ns.append(t)
        t += int(ms * 1e6)
    run.labels.append(((), -1))
    run.host_ns.append(t)
    p = profiling._REG.programs[pid]
    p.run = run
    profiling._ran(p)


def _host(name, start_ms, end_ms, **attrs):
    profiling._REG.spans.append(profiling.Span(name, int(start_ms * 1e6), int(end_ms * 1e6),
                                               -1, 1, attrs))


def test_composites_are_counted_per_body_run():
    """`composites` reads what a program's body formed in one run: 0 for a
    train program, 1 for the Adam solve, eager or captured (two warm-up
    runs and the capture each form one; replays run no body); and the
    composite's time is render's, outside the split of the iterations'."""
    from neural_jacobian_field_torch.inference.programs import ProgramCache
    from test_torch_port_programs import CountingBackend

    state = _state()
    _train_call(state)
    _solve(state.model, num_iters=3)
    state.model.programs = ProgramCache(CountingBackend())
    for _ in range(3):
        _solve(state.model, num_iters=3)
    got = sorted((k.split("#")[0], v["captures"], v["replays"], v["composites"])
                 for k, v in profiling.counters().items())
    assert got == [("encode", 0, 0, 0), ("encode", 1, 3, 0), ("solve", 0, 0, 1),
                   ("solve", 1, 3, 1), ("train", 0, 0, 0)]


def test_a_part_is_its_layer_outside_the_split():
    """A part's time (PARTS) goes to its layer after the shared time is
    split by the layers' own marked time."""
    run = profiling._Run(torch.device("cpu"), None)
    run.labels = [((), -1), (("render", "composite"), -1), (("render",), -1), (("loss",), -1),
                  (("iterations",), -1), ((), -1)]
    run.host_ns = [0, 10, 40, 50, 60, 100]
    p = profiling._Program(1, "solve", run=run, stamped=True)
    self_ms = profiling._summary(p)["self_ms"]
    # iterations' 40 split 1:1 by render's 10 and loss's 10; the part's 30 added after
    assert self_ms["render"] * 1e6 == pytest.approx(10 + 30 + 20)
    assert self_ms["loss"] * 1e6 == pytest.approx(10 + 20)
    assert "composite" not in self_ms


@pytest.mark.parametrize("metric,want_train,want_control", [
    ("encoder_ms", 6.0, 5.0),
    ("features_ms", 3.5, 1.5),
    ("field_ms", 8.0, 2.0),
    ("decoder_ms", 2.0, 0.5),
    ("render_ms", 1.0, 1.0 + 8.0 + 36.0 * 0.8),
    ("loss_ms", 1.5, 1.0 + 36.0 * 0.1),
    ("optimizer_ms", 2.5, 1.0 + 36.0 * 0.1),
])
def test_device_readers_on_a_hand_made_registry(metric, want_train, want_control):
    """Each device family per step of the train program's last run (two
    steps) and per request of the last encode plus the last solve (whose
    unmarked iterations are shared 8:1:1, as its marked ones give them);
    None for a registry that holds no run of the cell's programs."""
    sys.path.insert(0, str(REPO))
    from portbench.harness import cells

    read = cells.reader(f"{metric}.train").read
    assert read(_reader_cell("train_program"), None) is None
    step = [(("step",), 0.5), (("step", "encoder"), 2.0), (("step", "features"), 2.0),
            (("step", "sampler"), 1.0), (("step", "sampler", "field"), 3.0),
            (("step", "sampler"), 0.5), (("step", "decoder"), 0.5),
            (("step", "decoder", "field"), 5.0), (("step", "decoder"), 1.5),
            (("step", "render"), 1.0), (("step", "loss"), 1.5), (("step", "encoder"), 4.0),
            (("step", "optimizer"), 2.5)]
    _run("train", [((), 1.0)])  # an earlier program of the name: the last run counts
    _run("train", [((), 0.25)] + step + step, steps=True)
    assert read(_reader_cell("train_program"), None) == pytest.approx(want_train)
    _run("encode", [((), 0.1), (("encoder",), 5.0), (("features",), 1.0), (("sampler",), 0.5),
                    (("sampler", "field"), 2.0), (("decoder",), 0.5), (("render",), 1.0)])
    _run("solve", [((), 0.1), (("render",), 4.0), (("loss",), 0.5), (("render",), 3.0),
                   (("optimizer",), 0.5), (("iterations",), 36.0), (("render",), 1.0),
                   (("loss",), 0.5), (("optimizer",), 0.5)])
    assert cells.reader(f"{metric}.control").read(_reader_cell("control_loop"), None) == \
        pytest.approx(want_control)
    assert cells.reader(f"{metric}.action").read(_reader_cell("train_program"), None) == \
        pytest.approx(want_train)


def test_host_readers_on_a_hand_made_registry():
    """entry_host_ms: host ms inside the entry spans over the units they
    ran (a train call's steps; a request's encode and solve); capture_s:
    the captures' seconds; None where the registry holds none."""
    sys.path.insert(0, str(REPO))
    from portbench.harness import cells

    entry = cells.reader("entry_host_ms.train").read
    capture = cells.reader("capture_s.setup").read
    assert entry(_reader_cell("train_program"), None) is None
    assert entry(_reader_cell("control_loop"), None) is None
    assert capture(None, None) is None
    _host("njf.train.call", 0.0, 6.0, steps=6)
    _host("njf.train.split", 0.0, 1.0)
    _host("njf.train.call", 10.0, 13.0, steps=6)
    _host("njf.encode", 20.0, 21.0)
    _host("njf.solve", 21.0, 22.5)
    _host("njf.encode", 30.0, 30.5)
    _host("njf.solve", 30.5, 31.0)
    _host("njf.program.capture", 0.0, 2500.0)
    _host("njf.program.capture", 0.0, 500.0)
    assert entry(_reader_cell("train_program"), None) == pytest.approx(9.0 / 12)
    assert cells.reader("entry_host_ms.control").read(_reader_cell("control_loop"), None) == \
        pytest.approx(3.5 / 2)
    assert capture(None, None) == pytest.approx(3.0)


def test_readers_return_none_without_the_registry(monkeypatch):
    """A program without utils/profiling's registry functions (an older
    port) gives None, and nothing raises."""
    import types

    sys.path.insert(0, str(REPO))
    from portbench.harness import spans

    monkeypatch.setattr(spans, "_registry", lambda: types.SimpleNamespace())
    cell = _reader_cell("train_program")
    assert spans.layers_ms(cell, ("encoder",)) is None
    assert spans.entry_host_ms(cell) is None
    assert spans.capture_s() is None
