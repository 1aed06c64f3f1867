"""The multi-rank dry run (PyTorch counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): one real data-parallel step of each
stage on tiny shapes, over n ranks.

    python -m neural_jacobian_field_torch.parallel.dryrun [N] [--device cuda|cuda:0|cpu]
        [--backend nccl|gloo]

The same three checks at the same shapes as the JAX dry run (16x16 images, a
batch of n, a 2-stage BatchNorm encoder, epipolar knots (8, 4, 2), 4 + 4
samples, 16 rays): (1) a perception step, epipolar, with BatchNorm: its
loss finite, and the updated parameters and statistics bit for bit equal on
every rank; (2) the eval render from the updated statistics, each rank its
rows, gathered, against one process rendering the whole batch; (3) a
tracks step warm-started from that model, statistics included. Ranks are
NCCL processes one card each ("cuda", the default: N cards needed), gloo
processes sharing one card ("cuda:0" with --backend gloo), or gloo
processes on the CPU ("cpu").
"""

import sys

import torch

from .launch import rank_device, spawn
from .prefetch import to_device

ACTION_DIM, HW, RAYS, TRACKS = 4, 16, 16, 16


def dryrun_model_cfg():
    from ..models.encoder_resnet import EncoderResnetCfg
    from ..models.model import RenderingCfg, make_model_cfg

    return make_model_cfg(
        "jacobian_mlp", action_dim=ACTION_DIM,
        rendering=RenderingCfg(num_proposal_samples=(4,), num_nerf_samples=4,
                               pixel_feature_mode="epipolar", epipolar_knots=(8, 4, 2)),
        encoder=EncoderResnetCfg(norm_type="batch", num_layers=2))


def dryrun_batch(b: int, dev, seed: int = 0, tracks: bool = False):
    """The dry run's global batch of b, alike on every rank (seeded)."""
    from ..training import RawBatch

    g = torch.Generator().manual_seed(seed)
    eye = torch.eye(4).expand(b, 4, 4).clone()
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(b, 3, 3)
    batch = RawBatch(
        ctxt_rgb=torch.rand((b, HW, HW, 3), generator=g), ctxt_extrinsics=eye,
        ctxt_intrinsics=intr.clone(), robot_action=torch.zeros((b, ACTION_DIM)),
        trgt_rgb=torch.rand((b, HW, HW, 3), generator=g),
        trgt_depth=torch.full((b, HW, HW, 1), 2.0),
        trgt_extrinsics=eye.clone(), trgt_intrinsics=intr.clone(),
        near=torch.full((b,), 0.5), far=torch.full((b,), 10.0))
    if tracks:
        batch.pixel_selector = torch.randint(0, HW * HW, (b, TRACKS), generator=g)
        batch.pixel_motion = torch.randn((b, TRACKS, 2), generator=g)
        batch.pixel_visible_mask = torch.ones((b, TRACKS))
    return to_device(batch, dev)


def _new_model(dev):
    from ..models.model import Model

    model = Model(dryrun_model_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(dev)


def _same_on_every_rank(tensors, mesh) -> bool:
    from .mesh import all_gather

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])[None]
    rows = all_gather(flat, mesh)
    return bool((rows == rows[:1]).all())


def _eval_rgb(model, batch, yx, draws):
    from ..models.model import StepCtx
    from ..training.prepare import prepare_training_batch

    mi, _ = prepare_training_batch(batch, RAYS, yx=yx)
    with torch.no_grad():
        return model(mi, train=False, ctx=StepCtx(anneal=1.0, updated=True, draws=draws)).rgb


def dryrun_rank(rank: int, n: int, init_method: str, device: str, backend):
    """One rank of the dry run; returns its lines (rank 0's are printed)."""
    from ..training import TrainCfg, create_train_state, train_step
    from .mesh import all_gather, close_mesh, make_mesh, shard_batch, shard_rows

    dev = rank_device(rank, device)
    mesh = make_mesh(dev, init_method, rank, n, backend)
    lines = []
    try:
        model = _new_model(dev)
        batch = dryrun_batch(n, dev)
        cfg = TrainCfg(mode="perception", rays_per_batch=RAYS, warm_up_steps=10)
        state = create_train_state(model, cfg, mesh=mesh)
        metrics = train_step(state, shard_batch(batch, mesh),
                             torch.Generator(device=dev).manual_seed(1))
        loss = float(metrics["loss/total"])
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError(f"non-finite loss in the dry run: {loss}")
        if not _same_on_every_rank([*model.parameters(), *model.buffers()], mesh):
            raise RuntimeError("the ranks' parameters or BatchNorm statistics differ")
        lines.append(f"dryrun_multigpu({n}): perception DP step OK (epipolar, batch-norm, "
                     f"{mesh.backend} on {dev.type}), loss={loss:.4f}; parameters and "
                     "statistics bit for bit equal on every rank")

        # the eval render from the updated statistics: each rank its rows,
        # gathered, against one process rendering the whole batch
        g = torch.Generator(device=dev).manual_seed(7)
        yx = torch.stack([torch.randint(0, HW, (RAYS,), generator=g, device=dev)
                          for _ in range(2)], -1)
        draws = tuple(torch.rand((n, RAYS, s + 1), generator=g, device=dev) for s in (4, 4))
        whole = _eval_rgb(model, batch, yx, draws)
        sharded = all_gather(_eval_rgb(model, shard_batch(batch, mesh), yx,
                                       tuple(shard_rows(d, mesh) for d in draws)), mesh)
        diff = float((sharded - whole).abs().max())
        if not torch.allclose(sharded, whole, rtol=1e-3, atol=1e-4):  # the JAX dry run's
            raise RuntimeError(f"the sharded eval render differs from one process's: {diff}")
        lines.append(f"dryrun_multigpu({n}): batch_stats eval render matches one process "
                     f"(max abs diff {diff:.2e})")

        # the tracks step, warm-started from the stage-1 model and statistics
        cfg_a = TrainCfg(mode="action", rays_per_batch=TRACKS, warm_up_steps=10)
        state_a = create_train_state(_new_model(dev), cfg_a, init_params=model.state_dict(),
                                     mesh=mesh)
        metrics_a = train_step(state_a, shard_batch(dryrun_batch(n, dev, 2, tracks=True), mesh),
                               torch.Generator(device=dev).manual_seed(4))
        loss_a = float(metrics_a["loss/total"])
        if not torch.isfinite(torch.tensor(loss_a)):
            raise RuntimeError(f"non-finite action loss in the dry run: {loss_a}")
        if not _same_on_every_rank(list(state_a.model.parameters()), mesh):
            raise RuntimeError("the ranks' parameters differ after the tracks step")
        lines.append(f"dryrun_multigpu({n}): action/tracks DP step OK (epipolar, batch-norm, "
                     f"warm-started incl. batch_stats), loss={loss_a:.4f}")
        return {"lines": lines, "loss": loss, "loss_action": loss_a}
    finally:
        close_mesh()


def check_ranks(n: int, device: str, backend) -> None:
    """Raise where n ranks cannot run on `device` with `backend`: no card,
    or NCCL ranks that would share a card (NCCL refuses two ranks on one
    GPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multigpu: no CUDA device; pass device='cpu' "
                           "(--device cpu) for gloo ranks on the CPU")
    cards = 1 if dev.index is not None else torch.cuda.device_count()
    if n > cards and backend != "gloo":
        raise RuntimeError(f"dryrun_multigpu: {n} NCCL ranks need {n} cards, {cards} "
                           f"{'named' if dev.index is not None else 'visible'}; for ranks "
                           "that share one card pass --device cuda:0 --backend gloo")


def dryrun_multigpu(n: int, device: str = "cuda", backend=None, timeout_s: float = 300.0):
    """The dry run on n ranks (see the module docstring); prints rank 0's
    lines and returns rank 0's result. `device` "cuda" (NCCL, a card a rank;
    raises without n cards), "cuda:0" (with backend "gloo": ranks sharing
    the card) or "cpu" (gloo ranks on the CPU)."""
    check_ranks(n, device, backend)
    results = spawn(dryrun_rank, n, args=(device, backend), timeout_s=timeout_s,
                    threads=1 if device == "cpu" else 0)
    for line in results[0]["lines"]:
        print(line, flush=True)
    return results[0]


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    n, device, backend = 2, "cuda", None
    while args:
        a = args.pop(0)
        if a == "--device" and args:
            device = args.pop(0)
        elif a == "--backend" and args:
            backend = args.pop(0)
        elif a.isdigit():
            n = int(a)
        else:
            raise SystemExit("usage: python -m neural_jacobian_field_torch.parallel.dryrun "
                             "[N] [--device cuda|cuda:0|cpu] [--backend nccl|gloo]")
    dryrun_multigpu(n, device, backend)


if __name__ == "__main__":
    main()
