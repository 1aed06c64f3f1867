"""Rank functions for tests/test_torch_port_parallel.py, spawned as fresh
processes by neural_jacobian_field_torch.parallel.launch (each a gloo rank
on the CPU). This module imports no JAX, so a rank starts in seconds."""

import torch


def _tensors(arrays: dict):
    from neural_jacobian_field_torch.training import RawBatch

    return RawBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _model(cfg, state_dict):
    from neural_jacobian_field_torch.models.model import Model

    model = Model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def _record(state, metrics) -> dict:
    model = state.model
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params={n: p.detach().clone() for n, p in model.named_parameters()},
                grads={n: p.grad.detach().clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                buffers={n: b.detach().clone() for n, b in model.named_buffers()},
                step=state.step, ssu=state.steps_since_update)


def one_step(setup: dict, kind: str, mesh=None) -> dict:
    """One step of `kind` ("perception" or "tracks") from the setup's
    weights, on the rank's rows of the global batch (the whole batch
    without a mesh), with the global draws given; what the step left."""
    from neural_jacobian_field_torch.parallel import shard_batch
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, train_step

    mode = "perception" if kind == "perception" else "action"
    model = _model(setup["cfg"], setup["state_dict"])
    cfg = TrainCfg(mode=mode, lr=setup["lr"], warm_up_steps=setup["warmup"],
                   rays_per_batch=setup["rays"], log_sanity=setup.get("log_sanity", False))
    state = create_train_state(model, cfg, mesh=mesh)
    batch = _tensors(setup[kind]["arrays"])
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    yx, draws = setup[kind]["draws"]
    metrics = train_step(state, batch, updated=True, yx=yx, draws=draws)
    return _record(state, metrics)


def render(setup: dict, mesh=None):
    """The eval render of the setup's camera from its weights: sharded over
    the mesh, or render_camera in one process."""
    from neural_jacobian_field_torch.inference.render import render_camera, render_camera_sharded
    from neural_jacobian_field_torch.models.model import CameraInput, RobotInput

    r = setup["render"]
    model = _model(setup["cfg"], setup["state_dict"]).eval()
    t = {k: torch.from_numpy(v) for k, v in r["arrays"].items()}
    cam = CameraInput(input_image=t["image"], ctxt_extrinsics=t["ctxt"],
                      ctxt_intrinsics=t["intr"], trgt_extrinsics=t["trgt"],
                      trgt_intrinsics=t["intr"])
    kw = dict(z_near=r["near"], z_far=r["far"], height=r["hw"][0], width=r["hw"][1])
    if mesh is None:
        out = render_camera(model, cam, RobotInput(t["action"]), patch_size=r["patch"], **kw)
    else:
        out = render_camera_sharded(model, cam, RobotInput(t["action"]), mesh=mesh,
                                    patch_size=r["patch"] // mesh.size, **kw)
    return {k: v.clone() for k, v in vars(out).items()}


def steps_rank(rank: int, n: int, init_method: str, setup: dict) -> dict:
    """A gloo rank on the CPU: the perception step, the tracks step and the
    sharded render."""
    from neural_jacobian_field_torch.parallel import close_mesh, make_mesh

    mesh = make_mesh("cpu", init_method, rank, n)
    try:
        return dict(perception=one_step(setup, "perception", mesh),
                    tracks=one_step(setup, "tracks", mesh), render=render(setup, mesh))
    finally:
        close_mesh()


def cli_rank(rank: int, n: int, init_method: str, root: str, overrides: list, work: str) -> dict:
    """A gloo rank of the training CLI on the CPU, its checkpoints and logs
    under work/rank<r>; its parameters at the end."""
    from pathlib import Path

    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config
    from neural_jacobian_field_torch.parallel import close_mesh, make_mesh
    from neural_jacobian_field_torch.train import train

    mesh = make_mesh("cpu", init_method, rank, n)
    out = Path(work) / f"rank{rank}"
    try:
        cfg = get_typed_root_config(load_config(CONFIG_DIR, [
            f"dataset.root={root}", *overrides, f"checkpoint.dir={out / 'ck'}"]))
        state = train(cfg, device="cpu", mesh=mesh, log_dir=out / "logs")
        return dict(step=state.step, params={k: v.clone() for k, v in
                                             state.model.state_dict().items()})
    finally:
        close_mesh()
