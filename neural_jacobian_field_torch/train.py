"""Training CLI of the port (counterpart of the JAX package's train.py):

    python -m neural_jacobian_field_torch.train [--device cpu] [--profile N] \\
        dataset=dataset_allegro model=model_allegro \\
        dataset.root=/path/to/scene dataset.mode=perception
    python -m neural_jacobian_field_torch.train \\
        dataset.root=/path/to/scene dataset.mode=action checkpoint.load=checkpoints

The same dotted overrides over configurations/ (config/), the same data
pipeline (data/: dataset, loader, host-to-device prefetch) and the same
step loop: with training.steps_per_call = K > 1, K-step programs, a
statically gated one for each recurring post-warm-up gate tuple
(MultiStepDispatch, capped at the number of rotations of the gate cycle) and
per-substep one-step programs otherwise; with K = 1, the two gated one-step
programs. On the card every step program is a captured CUDA graph
(training/train.py). Metrics every 100 // K dispatches, with
perf/rays_per_sec; validation videos at each val_check_interval crossing;
checkpoints every checkpoint.every_n_train_steps (training/checkpoint.py).
`checkpoint.load` warm-starts the parameters from a checkpoint directory
this port wrote (the stage-2 start from stage 1), with a fresh optimizer.

It runs on the card unless `--device cpu` (or `device=` of `train`) asks
for the CPU, and raises where there is no card. With `--profile N` it
traces N dispatches of the steady window under torch.profiler: the first
N after the first log point past the proposal warm-up (N below the log
interval), the window's logged rate restarting after them. At the end it
writes <log_dir>/run.json: the loader's paths and the image decoders that
served, the captured programs, the validation frames written, and the
traced dispatches' device idle share.
"""

import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from .config import CONFIG_DIR, PipelineCfg, get_typed_root_config, load_config
from .data import DataLoader, get_dataset
from .data import image_io, native
from .data.loader import ValidationWrapper, collate, pin
from .models.model import Model
from .parallel import DevicePrefetcher, to_device
from .training import (MultiStepDispatch, TrainCfg, create_train_state, host_step_schedule,
                       make_multi_train_step, make_train_step, stack_batches)
from .training.checkpoint import CheckpointManager, load_params_only
from .utils.device import resolve_device
from .utils.logging import MetricsLogger, maybe_init_wandb
from .utils.profiling import device_idle_share

__all__ = ["CONFIG_DIR", "Trainer", "train", "main"]


class Trainer:
    """The CLI's set-up and step loop: `run()` trains to the step limit,
    `dispatch()` runs one dispatch (steps_per_call steps), `close()` stops
    the pipeline's threads and writes run.json."""

    def __init__(self, cfg: PipelineCfg, max_steps_override: Optional[int] = None,
                 log_dir=None, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        cuda = dev.type == "cuda"
        mode = cfg.dataset.mode
        print(f"mode={mode} device={dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if cuda else ""), flush=True)
        dataset = get_dataset(cfg.dataset, "train")
        self.num_tracks = None
        if mode == "action" and cfg.dataset.action_supervision_type == "tracks":
            self.num_tracks = ((cfg.dataset.num_positive_samples or 512)
                               + (cfg.dataset.num_negative_samples or 512))
        self.batch_size = cfg.training.data.batch_size
        self.spc = spc = max(int(cfg.training.steps_per_call), 1)
        # page-locked batches for an asynchronous copy to the card; K > 1
        # stacks K batches first and pins the stack
        self.loader = DataLoader(dataset, self.batch_size, num_tracks=self.num_tracks,
                                 num_workers=cfg.training.data.num_workers, seed=cfg.seed,
                                 pin_memory=cuda and spc == 1)
        host_iter = iter(self.loader)

        compute_dtype = (torch.bfloat16 if cfg.training.compute_dtype == "bfloat16"
                         else None)
        model = Model(cfg=cfg.model, compute_dtype=compute_dtype)
        model.init_weights(torch.Generator().manual_seed(cfg.seed))
        model.to(dev)
        self.tcfg = TrainCfg(
            mode=mode, lr=cfg.training.optim.lr, weight_decay=cfg.training.optim.weight_decay,
            warm_up_steps=cfg.training.optim.warm_up_steps,
            rays_per_batch=cfg.training.data.rays_per_batch or 256, loss=cfg.training.loss,
            grad_clip_norm=cfg.training.optim.grad_clip_norm,
            encoder_lr_scale=cfg.training.optim.encoder_lr_scale)
        next(host_iter)  # the JAX loop initialises its state from a first batch
        print("first batch ready", flush=True)
        if cfg.checkpoint.load:
            print(f"warm-starting params from {cfg.checkpoint.load}")
            load_params_only(cfg.checkpoint.load, model)
        self.state = create_train_state(model, self.tcfg)
        print("train state initialized", flush=True)

        self.ckpt = CheckpointManager(cfg.checkpoint.dir,
                                      save_interval_steps=cfg.checkpoint.every_n_train_steps)
        self.wandb_run = maybe_init_wandb(cfg.wandb)
        self.logger = MetricsLogger(log_dir=log_dir or Path("logs"), wandb_run=self.wandb_run)

        # validation data: one random item of the val split per pass, never
        # the training batch
        self.val_sampler = None
        if cfg.training.val_check_interval:
            try:
                self.val_sampler = ValidationWrapper(get_dataset(cfg.dataset, "val"),
                                                     seed=cfg.seed + 2)
            except Exception as e:  # e.g. no val frames in a tiny synthetic root
                print(f"val split unavailable ({e}); validating on train split")
                self.val_sampler = ValidationWrapper(dataset, seed=cfg.seed + 2)

        rendering = model.cfg.rendering
        if spc > 1:
            self.step_fn = make_multi_train_step(model, self.tcfg, steps_per_call=spc)
            # the steady gate cycle has period update_every + 1; a window of
            # spc steps sees cycle / gcd(spc, cycle) rotations of it, each a
            # recurring tuple that gets its own program on its second sight
            cycle = int(rendering.proposal_update_every) + 1
            rotations = cycle // math.gcd(spc, cycle)
            self.steady = MultiStepDispatch(
                lambda gt: make_multi_train_step(model, self.tcfg, steps_per_call=spc,
                                                 static_schedule=gt),
                warmup=int(rendering.proposal_warmup), max_programs=max(rotations, 4))
            stacked = (stack_batches([next(host_iter) for _ in range(spc)])
                       for _ in iter(int, 1))
            if cuda:
                stacked = map(pin, stacked)
            self.device_iter = DevicePrefetcher(stacked, dev, depth=2)
        else:
            # the two gated programs: past the warm-up only every
            # proposal_update_every-th step pays the proposal backward
            self.step_fns = {u: make_train_step(model, self.tcfg, static_updated=u)
                             for u in (True, False)}
            self.device_iter = DevicePrefetcher(host_iter, dev, depth=2)
        self.max_steps = max_steps_override or cfg.training.max_steps
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self.info = {"device": str(dev), "mode": mode, "steps_per_call": spc,
                     "batch_size": self.batch_size, "rays_per_batch": self.tcfg.rays_per_batch,
                     "validation_frames": [], "losses": []}
        self._t_last, self._n_last = time.time(), 0

    def dispatch(self):
        """One dispatch (steps_per_call steps) on the next staged batch;
        returns the step metrics (each [K] where K > 1)."""
        state = self.state
        batch = next(self.device_iter)
        if self.spc > 1:
            gates, ssu = [], state.steps_since_update
            for j in range(self.spc):
                g, ssu = host_step_schedule(state.step + j, ssu, state.model.cfg.rendering)
                gates.append(g)
            fn = self.steady.select(state.step, gates, self.step_fn)
            return fn(state, batch, generator=self.generator)
        updated, _ = host_step_schedule(state.step, state.steps_since_update,
                                        state.model.cfg.rendering)
        return self.step_fns[updated](state, batch, generator=self.generator)

    def run(self, profile: int = 0):
        """Train to the step limit. `profile` > 0 traces that many dispatches
        (Trainer.profile) at the first log point past the proposal warm-up
        where the steady programs are built; the logged rate then restarts,
        so no logged window holds a traced dispatch."""
        cfg, state = self.cfg, self.state
        print(f"starting training for {self.max_steps} steps ({self.spc} per dispatch)",
              flush=True)
        logged = -1  # the step of the last log point
        warmup = max(int(state.model.cfg.rendering.proposal_warmup), 10)
        while state.step < self.max_steps:
            prev = state.step
            if (profile and prev == logged and prev >= warmup
                    and (self.spc == 1 or len(self.steady))):
                metrics = self.profile(profile)
                profile = 0
                self._t_last, self._n_last = time.time(), state.step
            else:
                metrics = self.dispatch()
            i = state.step
            if prev == 0:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                print("first step captured + executed", flush=True)
            if (i // self.spc) % max(100 // self.spc, 1) == 0:
                host = {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
                dt = time.time() - self._t_last
                rays = (i - self._n_last) * self.batch_size * self.tcfg.rays_per_batch
                self.logger.log(i, {**host, "perf/rays_per_sec": rays / dt})
                self.info["losses"].append((i, host["loss/total"]))
                self._t_last, self._n_last = time.time(), i
                logged = i
            vci = cfg.training.val_check_interval
            if vci and self.val_sampler is not None and (prev // vci) != (i // vci):
                self.validate(i)
            self.ckpt.maybe_save(state)
        return state

    def validate(self, step: int):
        """An interpolated-camera validation video of one val item, rendered
        by the current weights through `render_camera`; frames written as
        PNGs under <log_dir>/val_<step>/ (or logged to wandb)."""
        from .visualization import render_interpolated_view

        raw = to_device(collate([self.val_sampler[0]], num_tracks=self.num_tracks),
                        self.device)
        rgb = raw.ctxt_rgb[:1]
        if rgb.dtype == torch.uint8:
            rgb = rgb.float() / 255.0
        h, w = raw.trgt_rgb.shape[1:3]
        videos = render_interpolated_view(
            self.state.model, ctxt_rgb=rgb, ctxt_extrinsics=raw.ctxt_extrinsics[:1],
            ctxt_intrinsics=raw.ctxt_intrinsics[:1], trgt_extrinsics=raw.trgt_extrinsics[:1],
            trgt_intrinsics=raw.trgt_intrinsics[:1], robot_action=raw.robot_action[:1],
            near=float(raw.near[0]), far=float(raw.far[0]),
            num_frames=self.cfg.validation.video.num_frames, height=h, width=w)
        if self.wandb_run is not None:
            import wandb

            for name, vid in videos.items():
                self.wandb_run.log({f"video/{name}": wandb.Video(
                    vid.transpose(0, 3, 1, 2), fps=self.cfg.validation.video.frame_rate,
                    format="mp4")}, step=step)
            return
        out = self.logger.log_dir / f"val_{step}"
        out.mkdir(parents=True, exist_ok=True)
        for name, vid in videos.items():
            for tag, frame in (("f0", vid[0]), ("mid", vid[len(vid) // 2])):
                image_io.write_rgb(out / f"{name}_{tag}.png", frame)
                self.info["validation_frames"].append(str(out / f"{name}_{tag}.png"))
        print(f"[val {step}] wrote frames -> {out}", flush=True)

    def profile(self, dispatches: int):
        """The device's idle share over the next `dispatches` dispatches, as
        torch.profiler sees it (utils/profiling.device_idle_share), into
        run.json; returns the last dispatch's metrics."""
        first, metrics = self.state.step, []
        out = device_idle_share(lambda: metrics.extend(self.dispatch()
                                                       for _ in range(dispatches)),
                                self.device)
        self.info["profile"] = {"dispatches": dispatches, "steps": [first, self.state.step],
                                **out}
        share = "not measured" if out["idle_share"] is None else f"{out['idle_share']:.4f}"
        print(f"profile: {dispatches} dispatches (steps {first}-{self.state.step}), traced "
              f"wall {out['wall_ms']:.3f} ms, device busy {out['busy_ms']:.3f} ms, idle share "
              f"{share}", flush=True)
        return metrics[-1]

    def close(self):
        self.device_iter.close()
        self.loader.close()
        self.logger.close()
        self.info.update(
            steps=self.state.step, loader_paths=dict(self.loader.paths),
            decoders=dict(image_io.DECODED), native=native.status(),
            programs=len(self.state.model.programs),
            steady_programs=len(self.steady) if self.spc > 1 else 0)
        if self.device.type == "cuda":
            self.info["peak_reserved_gib"] = torch.cuda.max_memory_reserved(self.device) / 2 ** 30
        (self.logger.log_dir / "run.json").write_text(json.dumps(self.info, indent=1))


def train(cfg: PipelineCfg, max_steps_override: Optional[int] = None, log_dir=None,
          device=None, profile: int = 0):
    """Train to the step limit; returns the TrainState (training/train.py).
    `device` None means the card; `profile` > 0 traces that many dispatches
    of the steady window (Trainer.run)."""
    trainer = Trainer(cfg, max_steps_override, log_dir, device)
    try:
        trainer.run(profile)
    finally:
        trainer.close()
    return trainer.state


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device, profile = None, 0
    while args and args[0].startswith("--"):
        flag = args.pop(0)
        if flag == "--device" and args:
            device = args.pop(0)
        elif flag == "--profile" and args:
            profile = int(args.pop(0))
        else:
            raise SystemExit(f"usage: python -m neural_jacobian_field_torch.train "
                             f"[--device DEVICE] [--profile N] [group=name] [a.b=value]... "
                             f"(unknown {flag!r})")
    cfg = get_typed_root_config(load_config(CONFIG_DIR, args))
    return train(cfg, device=device, profile=profile)


if __name__ == "__main__":
    main()
