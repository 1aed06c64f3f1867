"""Traffic kind "control_loop": one robot controller in a closed loop. Each
request is a new camera frame: `Model.encode_image` at the mix's rays, then
`optimize_actions` toward the request's desired flow, and the controller
waits for the action (a synchronize) before it sends the next frame. The
latency of a request runs from its send to the action's arrival.

Set-up: the served model (eval mode, weights of a trained model's
statistics) with the benchmark's weights, the frames, desired flows and
first actions of every request made on the device, and one request (the
captures of both programs) plus a second. The check: a sample of the
window's requests drawn from the seed; their encodings (density,
Jacobian, compositing weights, samples) and actions are kept on the host
as they come back (after the latency is taken), and once the window has
closed and the program is freed the reference encodes each sampled frame
itself and solves on the program's encoding (`reference_readings`)."""

import dataclasses
import time
from typing import Dict, List

from portbench.harness import stats
from portbench.harness.context import Outcome
from portbench.harness.inputs import cameras
from portbench.harness.program import build_model, memory_peak_bytes, sub_seed, synchronize
from portbench.harness.weights import (
    make_weights, running_statistics, served_density, serving)
from portbench.reference.model import Precision, parameter_spec, rays_from_coords
from portbench.reference.steps import Field, Rays, encode_image, solve


@dataclasses.dataclass
class Request:
    frame: object  # [1, H, W, 3]
    target: object  # [1, R, 2] desired flow
    action0: object  # [1, A]


@dataclasses.dataclass
class Session:
    model: object
    cam: object  # the CameraInput of every request but its frame
    rendering: object  # RenderingInput
    robot: object
    requests: List[Request]
    sampled: List[int]
    kept: Dict[int, dict] = dataclasses.field(default_factory=dict)
    done: int = 0
    spans: Dict[str, list] = dataclasses.field(default_factory=dict)

    def request(self, i: int, spans: bool = False):
        """Serve request i; returns its latency in seconds."""
        import torch

        from neural_jacobian_field_torch.inference.action_opt import optimize_actions

        r = self.requests[i % len(self.requests)]
        cam = dataclasses.replace(self.cam, input_image=r.frame)
        if spans:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        t0 = time.perf_counter()
        enc = self.model.encode_image(cam, self.rendering, self.robot)
        if spans:
            ev[1].record()
        res = optimize_actions(self.model, enc, cam, r.target, action0=r.action0,
                               num_iters=self.num_iters, learning_rate=self.lr)
        if spans:
            ev[2].record()
        synchronize(r.frame.device)
        latency = time.perf_counter() - t0
        if spans:
            self.spans.setdefault("encode_ms", []).append(ev[0].elapsed_time(ev[1]))
            self.spans.setdefault("solve_ms", []).append(ev[1].elapsed_time(ev[2]))
        if i in self.sampled and i not in self.kept:
            self.kept[i] = {"jac": enc.action_features.detach().float().cpu(),
                            "density": enc.density.detach().float().cpu(),
                            "weights": enc.weights.detach().float().cpu(),
                            "positions": enc.ray_samples_positions.detach().float().cpu(),
                            "action": res.action.detach().float().cpu()}
        return latency


def served_weights(cell, seed: int, device):
    """Seeded weights; the BatchNorm statistics those of a seeded frame, and
    the density heads' output set on that frame as the mix's
    "served_density" states (harness.weights.served_density)."""
    import torch

    tr, model = cell.traffic, cell.config["model"]
    weights = make_weights(serving(parameter_spec(model)), sub_seed(seed, "weights"), device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "statistics"))
    h, w = cell.config["image_hw"]
    image = torch.rand((1, h, w, 3), generator=g, device=device)
    running_statistics(weights, image, model["encoder"]["num_layers"])
    target = tr["served_density"]
    ctx_ext, trgt_ext, intr = cameras(tr, device)
    xy = _pixels(torch.randperm(h * w, generator=g, device=device)[:target["rays"]], h, w)
    origins, directions, _ = rays_from_coords(xy[None], intr[None], trgt_ext[None])
    span = torch.ones_like(origins[..., 0])
    served_density(weights, model, target, image,
                   Rays(origins, directions, tr["near"] * span, tr["far"] * span),
                   ctx_ext[None], intr[None], g, target["samples"])
    return weights


def _pixels(pick, h: int, w: int):
    """Flat pixel indices -> normalized (x, y) of the pixels' centres."""
    import torch

    return torch.stack([((pick % w).float() + 0.5) / w, ((pick // w).float() + 0.5) / h], dim=-1)


def setup(ctx) -> Session:
    import torch

    from neural_jacobian_field_torch.models.model import (
        CameraInput, RenderingInput, RobotInput)

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    h, w = cell.config["image_hw"]
    weights = served_weights(cell, ctx.seed, dev)
    model = build_model(cell.config, weights, dev).eval()
    del weights
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(ctx.seed, "inputs"))
    ctx_ext, trgt_ext, intr = cameras(tr, dev)
    rays = tr["rays"]
    xy = _pixels(torch.randperm(h * w, generator=g, device=dev)[:rays], h, w)
    origins, directions, _ = rays_from_coords(xy[None], intr[None], trgt_ext[None])
    a_dim = cell.config["model"]["action_dim"]
    requests = []
    for _ in range(tr["frames"]):
        # a smooth desired flow: a small seeded affine motion of the rays' pixels
        lin = tr["flow_scale"] * torch.randn((2, 3), generator=g, device=dev)
        target = (xy - 0.5) @ lin[:, :2].T + lin[:, 2]
        requests.append(Request(torch.rand((1, h, w, 3), generator=g, device=dev),
                                target[None].contiguous(),
                                tr["action0_std"] * torch.randn((1, a_dim), generator=g,
                                                                device=dev)))
    sample_g = torch.Generator().manual_seed(sub_seed(ctx.seed, "sample"))
    sampled = sorted(torch.randperm(tr["sample_from"], generator=sample_g)[:tr["sampled"]]
                     .tolist())
    cam = CameraInput(input_image=None, ctxt_extrinsics=ctx_ext[None],
                      ctxt_intrinsics=intr[None], trgt_extrinsics=trgt_ext[None],
                      trgt_intrinsics=intr[None])
    ri = RenderingInput(origins=origins, directions=directions,
                        z_near=torch.full((1,), tr["near"], device=dev),
                        z_far=torch.full((1,), tr["far"], device=dev))
    session = Session(model, cam, ri, RobotInput(torch.zeros((1, a_dim), device=dev)),
                      requests, sampled)
    session.num_iters, session.lr = tr["solve_iters"], tr["solve_lr"]
    for i in range(2):  # the captures, then a replay of each
        session.request(-1 - i)
    return session


def window(session: Session, seconds: float, spans: bool = False) -> List[float]:
    """Requests one after another for `seconds`; their latencies."""
    latencies = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        latencies.append(session.request(session.done, spans))
        session.done += 1
    return latencies


def release(session: Session):
    import gc

    import torch

    kept = {i: session.kept[i] for i in session.sampled if i in session.kept}
    frames = {i: session.requests[i % len(session.requests)] for i in kept}
    geometry = (session.cam, session.rendering)
    session.model.programs = None
    session.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return kept, frames, geometry


def _weighted_gap(w, got, want) -> float:
    """sqrt(sum w (got - want)^2) / sqrt(sum w want^2), w by sample."""
    w = w[..., None]
    return float((w * (got - want).pow(2)).sum().sqrt()
                 / (w * want.pow(2)).sum().sqrt().clamp_min(1e-30))


def expected_depth(weights, positions, rays, far: float):
    """Per ray, the distance along the ray at which it terminates, in
    expectation: each sample's distance by its compositing weight, the
    light left over at `far`. weights [B, R, S], positions [B, R, S, 3]."""
    o, d = rays.origins[:, :, None], rays.directions[:, :, None]
    t = ((positions - o) * d).sum(-1) / (d * d).sum(-1)
    return (weights * t).sum(-1) + (1.0 - weights.sum(-1)) * far


def reference_readings(cell, seed, kept, frames, geometry, device,
                       precision: str = "exact") -> Dict[str, float]:
    """Over the sampled requests, the largest of:
    - jacobian_gap: the Jacobian the program returned at its own final
      samples against the reference's field there (the reference's encoder,
      knots and Jacobian head), over every sample, each weighted by the
      program's compositing weight, relative;
    - density_gap: the density the program returned there against the
      reference's density trunk, in e-folds (natural log), RMS over the
      samples by the same weights: the density is an exponential, and a
      bf16 trunk's raw output is off by a fraction of an e-fold;
    - depth_gap: each ray's expected depth (`expected_depth`) from the
      program's compositing weights and samples less the one from the
      reference's own encoding (its densities, its proposal sampling and
      resampling, its compositing), the mean over the rays as a share of
      far - near: what the served density, the resampling (K5) and the
      compositing make of the scene, which neither the samples' exact
      places nor one ray's rounding decide;
    - solve_gap: the program's action against the reference's solve on the
      program's own encoding, relative.
    Read but not compared: depth_rms, the RMS over the rays of the same
    depth difference (a bf16 trunk's density moves each ray's transmission);
    positions_gap, the RMS distance of the program's
    final samples from the reference's own, in sample spacings ((far -
    near) / samples), which the resampling's sensitivity where a ray's
    weights are nearly nought makes swing from seed to seed, and
    samples_gap, the same weighted by the reference's compositing weights.
    At another `precision` the reference's own run there stands in for the
    program's returns."""
    import torch

    from portbench.reference.model import encode, ray_knots

    cam, ri = geometry
    weights = served_weights(cell, seed, device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tr, model = cell.traffic, cell.config["model"]
    out = dict.fromkeys(("jacobian_gap", "density_gap", "depth_gap", "solve_gap", "depth_rms",
                         "positions_gap", "samples_gap"), 0.0)
    spacing = (tr["far"] - tr["near"]) / model["rendering"]["num_nerf_samples"]
    try:
        fields = {"exact": Field(model, weights, Precision("exact"))}
        if precision != "exact":
            fields[precision] = Field(model, weights, Precision(precision))
        rays = Rays(ri.origins, ri.directions, ri.z_near[:, None].expand_as(ri.origins[..., 0]),
                    ri.z_far[:, None].expand_as(ri.origins[..., 0]))
        for i, k in kept.items():
            frame = frames[i].frame
            positions = k["positions"].to(device)
            w = k["weights"][..., 0].to(device)
            at, own = {}, {}  # by precision: (density, jacobian) at the program's samples;
            for name, field in fields.items():  # (weights, positions) of its own encoding
                with torch.no_grad():
                    pyr = encode(weights, frame, model["encoder"]["num_layers"], False, field.q,
                                 {})
                    knots = ray_knots(tuple(field.q(t) for t in pyr), rays.origins,
                                      rays.directions, rays.near, rays.far,
                                      cam.ctxt_extrinsics, cam.ctxt_intrinsics,
                                      tuple(model["rendering"]["epipolar_knots"]))
                    z, pe = field.point_inputs(knots, positions, cam.ctxt_extrinsics,
                                               cam.ctxt_intrinsics)
                    density, _ = field.density_head(z, pe)
                    at[name] = (density.reshape(k["density"].shape),
                                field.jacobian(z, pe).reshape(k["jac"].shape))
                _, _, own_w, own_pos = encode_image(field, frame, cam.ctxt_extrinsics,
                                                    cam.ctxt_intrinsics, rays)
                own[name] = (own_w, own_pos)
            if precision == "exact":
                got_at = (k["density"].to(device), k["jac"].to(device))
                got_own = (w, positions)
            else:
                got_at, got_own = at[precision], own[precision]
            want_at, want_own = at["exact"], own["exact"]
            depth = [expected_depth(ww, pp, rays, tr["far"]) for ww, pp in (got_own, want_own)]
            dist = (got_own[1] - want_own[1]).pow(2).sum(-1)
            a_ref, _ = solve(k["jac"].to(device), w, positions, cam.trgt_extrinsics,
                             cam.trgt_intrinsics, frames[i].target, frames[i].action0,
                             tr["solve_iters"], tr["solve_lr"])
            log_density = [d.clamp_min(1e-30).log()[..., 0] for d in (got_at[0], want_at[0])]
            readings = {
                "density_gap": float((w * (log_density[0] - log_density[1]).pow(2)).sum()
                                     .div(w.sum().clamp_min(1e-30)).sqrt()),
                "jacobian_gap": _weighted_gap(w, got_at[1], want_at[1]),
                "depth_gap": abs(float((depth[0] - depth[1]).mean())) / (tr["far"] - tr["near"]),
                "depth_rms": float((depth[0] - depth[1]).pow(2).mean().sqrt())
                / (tr["far"] - tr["near"]),
                "solve_gap": float((k["action"].to(device) - a_ref).norm()
                                   / a_ref.norm().clamp_min(1e-30)),
                "positions_gap": float(dist.mean().sqrt()) / spacing,
                "samples_gap": float((want_own[0] * dist).sum().sqrt()
                                     / want_own[0].sum().sqrt().clamp_min(1e-30)) / spacing}
            for key, v in readings.items():
                out[key] = max(out[key], v)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def run(ctx):
    import torch

    cell = ctx.cell
    session = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    latencies = window(session, ctx.seconds, spans=ctx.trace)
    out = Outcome(setup_s=setup_s, attempted=len(latencies), failed=0)
    ms = [1e3 * t for t in latencies]
    out.e2e["control_ms_p50"] = stats.percentile(ms, 50)
    out.context.update(requests=len(ms), spans=session.spans,
                       control_ms_p95=stats.percentile(ms, 95))
    if ctx.trace:
        n = cell.traffic["traced_requests"]
        start = session.done

        def traced():
            for j in range(n):
                session.request(start + j)

        out.trace = ctx.profile(traced, units=n)
        session.done += n
    out.memory_peak_bytes = memory_peak_bytes(ctx.device)
    kept, frames, geometry = release(session)
    out.checks = reference_readings(cell, ctx.seed, kept, frames, geometry, ctx.device)
    return out
