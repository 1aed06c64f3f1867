"""The comparison that decides `correct`, at a size the CPU holds: a run
with nothing broken is correct, and a run whose timed path is broken
underneath (a planted fault, harness/faults.py) or whose program is
replaced by the reference one precision step down (the control) is not.
The runs skip the look for a card and drive the rest of run.py's work:
set-up, a window, the check and the judgement against the cell's own
limits file. The program runs in float32 here, where it has no kernels;
on the card (the `cuda` test) the control is read at the cell's size."""

import pytest

from portbench import run
from portbench.harness import cells
from portbench.harness.faults import FAULTS

from portbench.tests.tiny import cpu_context, tiny_cell

SEED = 2 ** 31 + 977


def _train(workload, fault=None, precision=None):
    cell = tiny_cell(workload)
    drv = cells.kind_module(cell.kind)
    ctx = cpu_context(cell, SEED, seconds=0.5)
    if fault:
        with FAULTS[fault]():
            out = drv.run(ctx)
    else:
        out = drv.run(ctx)
    if precision:
        session = drv.setup(ctx)
        session.last_call()
        out.checks = drv.check(cell, drv.release(session), ctx.device, precision)
    return run.judge(cell, out)


def _control(fault=None, precision="exact"):
    cell = tiny_cell("allegro.control")
    drv = cells.kind_module(cell.kind)
    ctx = cpu_context(cell, SEED)
    if fault:
        with FAULTS[fault]():
            session = drv.setup(ctx)
            for i in range(cell.traffic["sample_from"]):
                session.request(i)
    else:
        session = drv.setup(ctx)
        for i in range(cell.traffic["sample_from"]):
            session.request(i)
    kept, frames, geometry = drv.release(session)
    checks = drv.reference_readings(cell, SEED, kept, frames, geometry, ctx.device, precision)
    from portbench.harness.context import Outcome

    out = Outcome(setup_s=0.0, attempted=len(kept), failed=0, checks=checks)
    return run.judge(cell, out)


def test_stage2_sound_run_is_correct():
    correct, rows = _train("allegro.stage2_tracks")
    assert correct, rows


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_stage2_fault_is_not_correct(fault):
    correct, rows = _train("allegro.stage2_tracks", fault=fault)
    assert not correct, rows


@pytest.mark.parametrize("workload", ["allegro.stage1", "allegro.stage2_tracks",
                                      "allegro_transformer.stage2_flow"])
def test_stale_inputs_are_not_correct(workload):
    """A program whose later calls read its first call's batch is held by
    the last checked call, which trains on another entry of the pool."""
    cell = tiny_cell(workload)
    with FAULTS["inputs_stale"]():
        out = cells.kind_module(cell.kind).run(cpu_context(cell, SEED, seconds=0.5))
    assert out.checks["last.loss_gap"] > cell.limits["loss_gap"], out.checks
    assert not run.judge(cell, out)[0]


@pytest.mark.parametrize("workload", ["allegro.stage1", "allegro.stage2_tracks",
                                      "allegro_transformer.stage2_flow"])
def test_state_unchanged_reads_one(workload):
    cell = tiny_cell(workload)
    with FAULTS["state_unchanged"]():
        out = cells.kind_module(cell.kind).run(cpu_context(cell, SEED, seconds=0.5))
    assert out.checks["first.step_gap"] == pytest.approx(1.0)
    assert out.checks["first.grad_gap"] == pytest.approx(1.0)
    assert not run.judge(cell, out)[0]


def test_stage2_control_is_not_correct():
    correct, rows = _train("allegro.stage2_tracks", precision="fp8")
    assert not correct, rows


def test_control_sound_run_is_correct():
    correct, rows = _control()
    assert correct, rows


def test_control_answer_altered_is_not_correct():
    correct, rows = _control(fault="answer_altered")
    assert not correct, rows


def test_control_density_fault_is_not_correct():
    correct, rows = _control(fault="density_scaled")
    assert not correct, rows
    assert dict((n, v) for n, v, _ in rows)["density_gap"] == pytest.approx(1.0, abs=1e-3)


def test_control_fp8_is_not_correct():
    correct, rows = _control(precision="fp8")
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["allegro.stage1", "allegro.control",
                                      "allegro.stage2_tracks", "allegro_transformer.stage2_flow"])
def test_control_fails_at_the_cells_size(card, workload):
    """The fp8 control on three seeds at the cell's own size fails its
    limits (`calibrate.py` prints the readings these limits were set from;
    a train cell's control fails at the call after a window, where the
    statistics have settled)."""
    import time

    from portbench.harness import context

    cell = cells.resolve(workload)
    drv = cells.kind_module(cell.kind)
    for seed in (3900000001, 3900000002, 3900000003):
        ctx = context.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False, device=card,
                                 t0=time.perf_counter())
        session = drv.setup(ctx)
        if cell.kind == "train_program":
            drv.window(session, 5.0)  # the last call after a window, as calibrate.py makes it
            session.last_call()
            checks = drv.check(cell, drv.release(session), card, "fp8")
        else:
            for i in range(max(session.sampled) + 1):
                session.request(i)
            kept, frames, geometry = drv.release(session)
            checks = drv.reference_readings(cell, seed, kept, frames, geometry, card, "fp8")
        out = context.Outcome(setup_s=0.0, attempted=1, failed=0, checks=checks)
        correct, rows = run.judge(cell, out)
        assert not correct, (seed, rows)
