"""The train steps as captured programs (training/train.py: make_train_step,
make_multi_train_step, MultiStepDispatch, stack_batches, the tensor-op
anneal, the skipped Jacobian trunk), on the CPU.

The small flagship-shaped model of tests/_torch_port_common.py in float32
with seeded weights and BatchNorm statistics, the 2-image batch of
tests/test_torch_port_train_step.py. The programs run through the fake
capture backends of tests/test_torch_port_programs.py, given a shared
memory pool: `EagerReplay` (a replay runs the step again on the static
buffers) holds the programs' plumbing bit for bit against eager steps, and
`CountingBackend` (a replay does nothing) holds the keying, the warm-ups
that leave the state as it was, and the launch accounting. Forward hooks
on the field trunks stand in for the K7 wrappers' counts, which count only
on the card. The card cases are in tests/test_torch_port_cuda.py; the K-step
program against JAX's make_multi_train_step is in
tests/test_torch_port_train_step.py.
"""

import contextlib
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _torch_port_common import jax_model_cfg, torch_model_cfg
from neural_jacobian_field_torch.inference.programs import ProgramCache
from neural_jacobian_field_torch.ops import kernels as K
from test_torch_port_programs import CountingBackend, EagerReplay
from test_torch_port_train_step import RAYS, _batch_arrays, _port_batch


class _Pooled:
    """A fake backend with memory pools: it records the pool of each capture."""

    def __init__(self):
        super().__init__()
        self.pools_made, self.pools_used = 0, []

    def pool(self):
        self.pools_made += 1
        return ("pool", self.pools_made)

    def capture(self, fn, inputs, pool=None):
        self.pools_used.append(pool)
        return super().capture(fn, inputs)


class PooledReplay(_Pooled, EagerReplay):
    @staticmethod
    def replay(handle):
        # a replay runs the step's Python again, backward included (a CUDA
        # graph replays its kernels whatever the grad mode)
        with torch.enable_grad():
            EagerReplay.replay(handle)


class PooledCounting(_Pooled, CountingBackend):
    pass


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are small and many; the suite runs test files in
    parallel worker processes, where torch's intra-op threads would contend
    for the cores, so each test runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def programs_on_cpu(model, backend):
    saved = model.programs
    model.programs = ProgramCache(backend)
    try:
        yield model.programs
    finally:
        model.programs = saved


def _state(mode="perception", seed=3):
    """A train state of the small model with seeded weights (the Jacobian head
    at the density head's scale) and BatchNorm statistics; stage 2 trains
    the Jacobian head alone."""
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    g = torch.Generator().manual_seed(seed)
    model = Model(torch_model_cfg()).init_weights(g)
    head = model.decoder.jacobian_head
    head.near_zero_init = False
    head.init_weights(g)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    return create_train_state(model, TrainCfg(mode=mode, lr=1e-3, warm_up_steps=4,
                                              rays_per_batch=RAYS))


def _batch(mode="perception", seed=11):
    batch = _port_batch(_batch_arrays(seed))
    if mode == "action":
        b, h, w = batch.trgt_rgb.shape[:3]
        g = torch.Generator().manual_seed(seed)
        batch = replace(batch, flow=torch.randn((b, h, w, 2), generator=g))
    return batch


def _everything(state):
    """Parameters, buffers, Adam's state (the count, the moments) and the
    host's counters."""
    opt = state.optimizer
    return ([t.detach().clone() for t in state.model.parameters()]
            + [t.clone() for t in state.model.buffers()]
            + [t.clone() for t in opt.state_tensors()]
            + [torch.tensor([state.step, state.steps_since_update])])


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), i


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@contextlib.contextmanager
def trunk_counts(model):
    """Count each field trunk's forward evaluations in K7-tz-fwd's counter,
    as the wrapper counts its launches on the card."""
    from neural_jacobian_field_torch.models.resnet_fc import ResnetFC

    def hook(*_):
        K.fused_resnet_fc_tz.launches += 1

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ResnetFC)]
    K.reset_launch_counts()
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        K.reset_launch_counts()


# ---------------------------------------------------- programs against eager

@pytest.mark.parametrize("mode", ["perception", "action"])
def test_train_programs_are_the_eager_steps(mode):
    """An update step, a frozen step and an update step again (make_train_step
    with the gate baked in), a 2-step program (False, True) twice on other
    batches, and a 2-step call on the schedule's gates, each with
    randomness drawn from a generator, through EagerReplay programs:
    metrics, parameters, BatchNorm statistics, Adam's state and the host's
    counters equal those of eager train_step calls bit for bit after every
    call; the programs are the update, frozen and 2-step ones, captured
    once each into one pool."""
    from neural_jacobian_field_torch.training import (
        make_multi_train_step, make_train_step, stack_batches, train_step)

    batch, batch2 = _batch(mode), _batch(mode, seed=12)
    eager, captured = _state(mode), _state(mode)
    model, cfg = captured.model, captured.cfg
    steps = {g: make_train_step(model, cfg, static_updated=g) for g in (True, False)}
    multi = make_multi_train_step(model, cfg, 2, static_schedule=(False, True))
    scheduled = make_multi_train_step(model, cfg, 2)
    ge, gc = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)

    def stacked_metrics(ms):
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    backend = PooledReplay()
    with programs_on_cpu(model, backend) as cache:
        for gate in (True, False, True):
            want = train_step(eager, batch, ge, gate)
            _same_metrics(steps[gate](captured, batch, generator=gc), want)
            _same(_everything(captured), _everything(eager))
        for pair in ((batch, batch2), (batch2, batch)):
            want = [train_step(eager, b, ge, g) for b, g in zip(pair, (False, True))]
            _same_metrics(multi(captured, stack_batches(pair), generator=gc),
                          stacked_metrics(want))
            _same(_everything(captured), _everything(eager))
        want = [train_step(eager, b, ge) for b in (batch2, batch)]
        got = scheduled(captured, stack_batches([batch2, batch]), generator=gc)
        _same_metrics(got, stacked_metrics(want))
        _same(_everything(captured), _everything(eager))
        assert len(cache) == 3
    assert backend.pools_made == 1 and backend.pools_used == [("pool", 1)] * 3
    assert captured.step == 9


@pytest.mark.parametrize("mode", ["perception", "action"])
def test_multi_step_is_its_single_steps(mode):
    """Eagerly on the CPU (no programs), a K-step call equals K sequential
    train_step calls bit for bit: with a baked schedule and explicit
    K-stacked randomness, and on the schedule's gates with randomness from a
    generator."""
    from neural_jacobian_field_torch.training import (
        make_multi_train_step, stack_batches, step_randomness, train_step)

    batches = [_batch(mode, seed) for seed in (11, 12)]
    eager, multi = _state(mode), _state(mode)
    g = torch.Generator().manual_seed(9)
    drawn = [step_randomness(eager, b, g) for b in batches]
    gates = (True, False)
    want = [train_step(eager, b, None, u, yx=yx, draws=d)
            for b, u, (yx, d) in zip(batches, gates, drawn)]
    got = make_multi_train_step(multi.model, multi.cfg, 2, static_schedule=gates)(
        multi, stack_batches(batches), yx=torch.stack([yx for yx, _ in drawn]),
        draws=[torch.stack(ds) for ds in zip(*(d for _, d in drawn))])
    _same_metrics(got, {k: torch.stack([m[k] for m in want]) for k in want[0]})
    _same(_everything(multi), _everything(eager))
    ge, gm = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    want = [train_step(eager, b, ge) for b in batches]
    got = make_multi_train_step(multi.model, multi.cfg, 2)(multi, stack_batches(batches),
                                                           generator=gm)
    _same_metrics(got, {k: torch.stack([m[k] for m in want]) for k in want[0]})
    _same(_everything(multi), _everything(eager))
    assert multi.step == 4


# ------------------------------------------------------------------ plumbing

def test_train_program_plumbing():
    """Through CountingBackend (a replay runs nothing): the warm-up calls and
    the capture leave the state as they found it, the host's counters
    advance once a call, the batch is copied into static buffers, each
    replay adds the captured launches (two trunks a stage-1 step: the
    proposal density and the NeRF density, no Jacobian trunk), and the
    program is kept while the weights and Adam's state are loaded in place,
    and captured again when weights or Adam's state are reassigned or a
    group's settings change."""
    from neural_jacobian_field_torch.training import make_train_step

    state, batch = _state(), _batch()
    model, opt = state.model, state.optimizer
    step = make_train_step(model, state.cfg, static_updated=False)
    backend = PooledCounting()
    before = _everything(state)
    with programs_on_cpu(model, backend) as cache, trunk_counts(model):
        step(state, batch, generator=torch.Generator().manual_seed(0))
        assert backend.captured == 1 and backend.replayed == 1
        # two warm-ups ran (two trunks each; the capture's are taken back)
        # and the replay counts two; nothing moved
        assert K.fused_resnet_fc_tz.launches == 2 * 2 + 2
        _same(_everything(state)[:-1], before[:-1])
        assert (state.step, state.steps_since_update) == (1, 1)
        (program,) = list(cache)
        assert program.launches["K7-tz-fwd"] == (2, 0)
        assert program.inputs[0] is not batch.ctxt_rgb
        assert torch.equal(program.inputs[0], batch.ctxt_rgb)
        for _ in range(3):
            step(state, batch, generator=torch.Generator().manual_seed(0))
        assert backend.captured == 1 and backend.replayed == 4
        assert K.fused_resnet_fc_tz.launches == 2 * 2 + 2 * 4
        assert state.step == 4

        def captures_after(change, programs=1):
            n = backend.captured
            change()
            step(state, batch, generator=torch.Generator().manual_seed(0))
            assert len(cache) == programs
            return backend.captured - n

        sd, osd = model.state_dict(), opt.state_dict()
        tensors = opt.state_tensors()
        assert captures_after(lambda: model.load_state_dict(sd)) == 0
        assert captures_after(lambda: opt.load_state_dict(osd)) == 0
        assert all(a is b for a, b in zip(opt.state_tensors(), tensors))

        def reassign():
            for q in model.parameters():
                q.data = q.data.clone()

        assert captures_after(reassign) == 1
        # as utils/from_jax.load_optax_adam_state does: new state tensors
        p = opt.params()[0]
        assert captures_after(lambda: opt.state.__setitem__(p, {
            "step": torch.tensor(4.0), "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)})) == 1
        # another setting: another program, beside the first
        assert captures_after(lambda: opt.param_groups[0].update(lr_mult=0.5), 2) == 1
    assert backend.pools_made == 1


def test_optimizer_state_loads_in_place():
    """Adam's load_state_dict copies into the tensors it held (the count
    too), so a program that reads them sees the loaded values; a count set
    from outside is taken over by prepare()."""
    from neural_jacobian_field_torch.training import train_step

    src, dst = _state(), _state(seed=4)
    for _ in range(2):
        train_step(src, _batch(), torch.Generator().manual_seed(1), True)
    held = dst.optimizer.state_tensors()
    dst.optimizer.load_state_dict(src.optimizer.state_dict())
    got, want = dst.optimizer.state_tensors(), src.optimizer.state_tensors()
    assert all(a is b for a, b in zip(got, held))
    _same(got, want)
    assert float(got[0]) == 2.0
    p = dst.optimizer.params()[0]
    dst.optimizer.state[p]["step"] = torch.tensor(7.0)
    assert float(dst.optimizer.prepare()) == 7.0 and dst.optimizer.prepare() is held[0]


# ------------------------------------------------------ the skipped trunk

def test_perception_step_skips_the_jacobian_trunk():
    """A stage-1 forward that renders no flow evaluates two field trunks,
    not three, and gives the loss, the metrics and every gradient of one
    that does, bit for bit; the output carries no flow. After a whole step
    the Jacobian head, which no stage-1 loss reaches, has moved by weight
    decay alone (optax's zero-gradient step): its non-zero entries moved,
    its zero biases stayed."""
    from neural_jacobian_field_torch.models.model import StepCtx
    from neural_jacobian_field_torch.training import (
        perception_loss, prepare_training_batch, step_randomness, train_step)

    state, batch = _state(), _batch()
    model = state.model
    yx, draws = step_randomness(state, batch, torch.Generator().manual_seed(2))
    runs = {}
    for render_flow in (True, False):
        mi, mt = prepare_training_batch(batch, RAYS, yx=yx)
        ctx = StepCtx(anneal=torch.tensor(0.25), updated=True, draws=draws,
                      render_flow=render_flow)
        model.zero_grad(set_to_none=True)
        with trunk_counts(model):
            out = model(mi, train=True, ctx=ctx)
            trunks = K.fused_resnet_fc_tz.launches
        loss, metrics = perception_loss(out, mt)
        loss.backward()
        runs[render_flow] = (trunks, out.optical_flow, loss.detach(), metrics,
                             {n: p.grad for n, p in model.named_parameters()})
    (t1, flow1, l1, m1, g1), (t0, flow0, l0, m0, g0) = runs[True], runs[False]
    assert (t1, t0) == (3, 2) and flow1 is not None and flow0 is None
    assert torch.equal(l1, l0)
    _same_metrics(m0, m1)
    assert g0.keys() == g1.keys()
    for n in g1:
        assert (g0[n] is None) == (g1[n] is None), n
        assert g1[n] is None or torch.equal(g0[n], g1[n]), n
    assert all(g1[n] is None for n in g1 if n.startswith("decoder.jacobian_head."))

    head = {n: p.detach().clone() for n, p in model.decoder.jacobian_head.named_parameters()}
    train_step(state, batch, None, True, yx=yx, draws=draws)
    for n, p in model.decoder.jacobian_head.named_parameters():
        assert torch.equal(p.detach() != head[n], head[n] != 0), n
        assert torch.equal(p.grad, torch.zeros_like(p)), n
    assert any(bool((h != 0).any()) for h in head.values())


# ------------------------------------------------------------------ anneal

def test_tensor_anneal_is_the_float_one():
    """step_anneal on a float32 count against step_schedules' float anneal
    (float64 on the host) and the JAX step's float32 one, over steps
    0-3,000 (the anneal ends at 1,000): float32 rounding apart (1e-6
    relative). Without the anneal it is 1."""
    from neural_jacobian_field_tpu.rendering.samplers import proposal_anneal as j_anneal
    from neural_jacobian_field_torch.models.model import step_anneal, step_schedules

    rcfg = torch_model_cfg().rendering
    steps = np.arange(0, 3001)
    got = np.array([float(step_anneal(torch.tensor(float(s)), rcfg)) for s in steps])
    host = np.array([step_schedules(int(s), 0, rcfg)[0] for s in steps])
    jcfg = jax_model_cfg().rendering
    want = np.asarray(jax.jit(jax.vmap(lambda s: j_anneal(
        s, jcfg.proposal_weights_anneal_max_num_iters,
        jcfg.proposal_weights_anneal_slope)))(jax.numpy.asarray(steps, jax.numpy.int32)))
    np.testing.assert_allclose(got, host, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[-1] == 1.0
    off = replace(rcfg, use_proposal_weight_anneal=False)
    assert float(step_anneal(torch.tensor(17.0), off)) == 1.0


# ------------------------------------------------------- MultiStepDispatch

@pytest.mark.parametrize("spc,max_programs", [(4, 4), (6, 4), (4, 2)])
def test_multi_step_dispatch_matches_jax(spc, max_programs):
    """The port's MultiStepDispatch against the JAX package's class over 200
    steps of host_step_schedule windows (proposal warmup 60, update every
    5): the same program or default for every window, and the same gate
    tuples built; spc 4 sees three rotations of the 6-step cycle, so a cap of
    2 leaves one on the default."""
    from neural_jacobian_field_tpu.training.train import MultiStepDispatch as JDispatch
    from neural_jacobian_field_tpu.training.train import host_step_schedule as j_host
    from neural_jacobian_field_torch.training import MultiStepDispatch, host_step_schedule

    tcfg = replace(torch_model_cfg().rendering, proposal_warmup=60)
    jcfg = replace(jax_model_cfg().rendering, proposal_warmup=60)
    ours = MultiStepDispatch(lambda gt: ("program", gt), warmup=60, max_programs=max_programs)
    theirs = JDispatch(lambda gt: ("program", gt), warmup=60, max_programs=max_programs)
    picks, ssu_t, ssu_j = [], 0, 0
    for i in range(0, 200, spc):
        gt, gj = [], []
        for j in range(spc):
            u, ssu_t = host_step_schedule(i + j, ssu_t, tcfg)
            gt.append(u)
            u, ssu_j = j_host(i + j, ssu_j, jcfg)
            gj.append(u)
        assert gt == gj
        pick = ours.select(i, gt, "default")
        assert pick == theirs.select(i, gj, "default")
        picks.append(pick)
    built = {p for p in picks if p != "default"}
    assert built == {("program", gt) for gt in theirs._programs}
    assert len(built) == min(max_programs, 3 if spc == 4 else 1)
    assert picks[-1] != "default" or max_programs < 3
