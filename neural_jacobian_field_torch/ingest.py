"""Pretrained-weight ingestion (the counterpart of tools/ingest_weights.py):
one command from a torch weight file to the port's state dict, a
machine-readable report and, with --eval, a quality smoke.

    python -m neural_jacobian_field_torch.ingest <checkpoint> [--kind auto] \\
        [--out ported.pt] [--eval] [--raft-iters 12] [--action-dim 8] \\
        [--decoder jacobian_mlp] [--device cpu]

Kinds (detected from the state_dict's keys with --kind auto):
  raft       princeton-vl raft-things.pth, or torchvision's Raft_Large_Weights
             saved as a plain state_dict (flow/raft.py)
  reference  a reference-repo Lightning checkpoint ("model."-prefixed keys;
             utils/port_torch.py), into the exact-mode model with BatchNorm
             and the concat encoder layout
  dinov2     a torch.hub dinov2_vits14 state dict, into the 2D family's
             ViT-S/14 (jacobian2d/vit.py); --eval: patch-token statistics
             on a deterministic 56x56 image

It writes `torch.save` of the port's state dict to --out (default
<checkpoint>.torch.pt) and prints one JSON report line: kind, out,
consumed, unused, overwritten, total_leaves (and unused_keys, eval). The
model runs on the card unless --device names another, and the command
raises where there is no card and no device is named.
"""

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.port_torch import load_torch_state_dict

KINDS = ("auto", "raft", "dinov2", "reference")


def detect_kind(sd: dict) -> str:
    keys = set(sd)
    if any(k.startswith(("update_block.", "module.update_block.")) for k in keys):
        return "raft"
    if "patch_embed.proj.weight" in keys and "cls_token" in keys:
        return "dinov2"
    if any(k.startswith(("model.encoder.", "encoder.model.")) for k in keys):
        return "reference"
    raise SystemExit("cannot auto-detect checkpoint kind from its keys; pass --kind "
                     "(saw e.g. " + ", ".join(sorted(keys)[:5]) + ")")


def _changed(before: dict, after: dict) -> int:
    return sum(not torch.equal(before[k], after[k].cpu()) for k in before)


def fixture_pair(h: int = 96, w: int = 128):
    """The JAX CLI's deterministic pair: a seeded texture and the same
    texture 3 px to the left, [1, H, W, 3] each."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 1, (h + 8, w + 8, 3)).astype(np.float32)
    return (torch.from_numpy(base[4:4 + h, 4:4 + w].copy())[None],
            torch.from_numpy(base[4:4 + h, 7:7 + w].copy())[None])


def ingest_raft(sd: dict, run_eval: bool, num_iters: int, device):
    from .flow import RAFT, load_torch_raft_state_dict

    raft = RAFT(num_iters=num_iters, device=device).init_weights(
        torch.Generator().manual_seed(0))
    before = {k: v.detach().cpu().clone() for k, v in raft.state_dict().items()}
    unused: list = []
    load_torch_raft_state_dict(raft, sd, unused_out=unused)
    state = raft.state_dict()
    report = {"consumed": len(sd) - len(unused), "unused": len(unused),
              "overwritten": _changed(before, state), "total_leaves": len(state)}
    if unused:
        report["unused_keys"] = unused[:10]
    if run_eval:
        dev = raft.mask_conv2.weight.device
        a, b = fixture_pair()
        with torch.no_grad():
            flow = raft(a.to(dev), b.to(dev)).cpu().numpy()
        med = np.median(flow.reshape(-1, 2), axis=0)
        report["eval"] = {"finite": bool(np.isfinite(flow).all()),
                          "median_flow_px": [round(float(m), 3) for m in med],
                          "expected_if_pretrained": [3.0, 0.0]}
    return state, report


def ingest_dinov2(sd: dict, run_eval: bool, device):
    from .jacobian2d.vit import ViTS14, load_torch_dinov2_state_dict

    vit = ViTS14().init_weights(torch.Generator().manual_seed(0)).to(device)
    before = {k: v.detach().cpu().clone() for k, v in vit.state_dict().items()}
    unused: list = []
    load_torch_dinov2_state_dict(vit, sd, unused_out=unused)
    state = vit.state_dict()
    report = {"consumed": len(sd) - len(unused), "unused": len(unused),
              "overwritten": _changed(before, state), "total_leaves": len(state)}
    if unused:
        report["unused_keys"] = unused[:10]
    if run_eval:
        img, _ = fixture_pair(h=14 * 4, w=14 * 4)
        with torch.no_grad():
            feats = vit(img.to(device)).cpu().numpy()
        report["eval"] = {"finite": bool(np.isfinite(feats).all()), "tokens": list(feats.shape),
                          "feat_std": round(float(feats.std()), 4)}
    return state, report


def reference_model(action_dim: int, decoder: str, device):
    """The exact-mode template the reference checkpoints were trained under
    (pixel_aligned_features.py:11-35): BatchNorm, concat layout."""
    from .models.encoder_resnet import EncoderResnetCfg
    from .models.model import Model, RenderingCfg, make_model_cfg

    cfg = make_model_cfg(decoder, action_dim=action_dim,
                         rendering=RenderingCfg(pixel_feature_mode="exact"),
                         encoder=EncoderResnetCfg(norm_type="batch", feature_layout="concat"))
    model = Model(cfg).init_weights(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def ingest_reference(sd: dict, run_eval: bool, action_dim: int, decoder: str, device):
    from .utils.port_torch import merge_reference_state, port_reference_checkpoint

    model = reference_model(action_dim, decoder, device)
    matched, skipped = merge_reference_state(model, port_reference_checkpoint(sd))
    report = {"consumed": matched, "unused": len(skipped), "overwritten": matched,
              "total_leaves": sum(1 for _ in model.parameters())}
    if skipped:
        report["unused_keys"] = skipped[:10]
    if run_eval:
        report["eval"] = _render_smoke(model, action_dim)
    return model.state_dict(), report


def _render_smoke(model, action_dim: int) -> dict:
    """A 64x64 eval-mode render of a seeded image from a camera 10 degrees
    off the context one: finite, and its rgb range."""
    from .inference.render import render_camera
    from .models.model import CameraInput, RobotInput

    dev = next(model.parameters()).device
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.uniform(size=(1, 64, 64, 3)).astype(np.float32))
    intr = torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]]])
    t = np.radians(10.0)
    trgt = torch.eye(4)
    trgt[:3, :3] = torch.tensor([[np.cos(t), 0.0, np.sin(t)], [0.0, 1.0, 0.0],
                                 [-np.sin(t), 0.0, np.cos(t)]], dtype=torch.float32)
    trgt[:3, 3] = torch.tensor([0.0, 0.0, 2.0]) - trgt[:3, :3] @ torch.tensor([0.0, 0.0, 2.0])
    cam = CameraInput(input_image=image.to(dev), ctxt_extrinsics=torch.eye(4)[None].to(dev),
                      ctxt_intrinsics=intr.to(dev), trgt_extrinsics=trgt[None].to(dev),
                      trgt_intrinsics=intr.to(dev))
    action = torch.from_numpy(0.1 * rng.normal(size=(1, action_dim)).astype(np.float32))
    out = render_camera(model, cam, RobotInput(robot_action=action.to(dev)), z_near=0.5,
                        z_far=10.0, height=64, width=64, patch_size=1024)
    rgb = out.rgb.float().cpu().numpy()
    return {"finite": bool(np.isfinite(rgb).all()),
            "rgb_range": [round(float(rgb.min()), 4), round(float(rgb.max()), 4)]}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--kind", default="auto", choices=KINDS)
    ap.add_argument("--out", default=None,
                    help="output file of the port's state dict (default <ckpt>.torch.pt)")
    ap.add_argument("--eval", action="store_true", help="run the kind's quality smoke")
    ap.add_argument("--action-dim", type=int, default=8)
    ap.add_argument("--decoder", default="jacobian_mlp")
    ap.add_argument("--raft-iters", type=int, default=12,
                    help="GRU iterations of the raft --eval smoke")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the card; cpu to run on the CPU)")
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.checkpoint)
    kind = detect_kind(sd) if args.kind == "auto" else args.kind
    device = resolve_device(args.device, "ingestion")
    if kind == "raft":
        state, report = ingest_raft(sd, args.eval, args.raft_iters, device)
    elif kind == "dinov2":
        state, report = ingest_dinov2(sd, args.eval, device)
    else:
        state, report = ingest_reference(sd, args.eval, args.action_dim, args.decoder, device)
    out = args.out or (args.checkpoint + ".torch.pt")
    torch.save({k: v.detach().cpu() for k, v in state.items()}, out)
    print(json.dumps({"kind": kind, "out": out, **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
