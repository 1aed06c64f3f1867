"""The plain reference of the neural-Jacobian-field model: float32 PyTorch,
written out from the published model (PixelNeRF-style ResNet-34 pyramid,
epipolar ray knots, proposal sampling, ResnetFC field trunks, a Jacobian
MLP or transformer decoder, volume compositing, the perception and action
losses and optax's Adam). It imports nothing of the program under test and
keeps none of its kernels, layouts or caches: every contraction is a plain
`F.conv2d`, `F.linear` or `torch.matmul` in float32 with TF32 off.

Parameters are a flat dict keyed by the program's state-dict names, made
by the benchmark from the seed (`parameter_spec` says which names, shapes
and initial distributions exist); buffers (BatchNorm running statistics)
sit in the same dict. `Precision` rounds the operands of every contraction:
`exact` leaves float32 alone, `fp8` rounds each operand to float8 e4m3 with
a per-tensor scale (the control: the step below the configurations' bf16).
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # ResNet-34: blocks, channels
FP8_MAX = 448.0


class Precision:
    """Rounds the operands of each contraction (forward only; gradients pass
    straight through): "exact" (float32) or "fp8" (e4m3, scaled by the
    tensor's largest magnitude)."""

    def __init__(self, kind: str = "exact"):
        if kind not in ("exact", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "exact":
            return x
        with torch.no_grad():
            s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
            r = (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (r - x).detach()


# ----------------------------------------------------------------- parameters

def _linear_spec(prefix: str, d_in: int, d_out: int, kind: str, bias: bool = True):
    out = [(f"{prefix}.weight", (d_out, d_in), kind)]
    if bias:
        out.append((f"{prefix}.bias", (d_out,), "near_zero" if kind == "near_zero" else "zeros"))
    return out


def _trunk_spec(prefix: str, mlp: dict, d_in: int, d_out: int, d_latent: int,
                near_zero: bool):
    dh = mlp["d_hidden"]
    k_in = "near_zero" if near_zero else "kaiming_in"
    k_res = "near_zero" if near_zero else "kaiming_in_small"
    spec = _linear_spec(f"{prefix}.lin_in", d_in, dh, k_in)
    for i in range(min(mlp["combine_layer"], mlp["n_blocks"])):
        spec += _linear_spec(f"{prefix}.lin_z_{i}", d_latent, dh, k_in)
    for i in range(mlp["n_blocks"]):
        spec += _linear_spec(f"{prefix}.blocks_{i}_fc_0", dh, dh, k_in)
        spec += _linear_spec(f"{prefix}.blocks_{i}_fc_1", dh, dh, k_res)
    spec += _linear_spec(f"{prefix}.lin_out", dh, d_out, k_in)
    return spec


def _bn_spec(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "ones"), (f"{prefix}.bias", (c,), "zeros"),
            (f"{prefix}.running_mean", (c,), "zeros"), (f"{prefix}.running_var", (c,), "ones")]


def encoder_blocks(num_layers: int) -> List[Tuple[int, str, int, int, int]]:
    """(stage, name, cin, channels, stride) of every BasicBlock."""
    out, cin = [], 64
    for stage in range(num_layers - 1):
        n, c = STAGES[stage]
        for i in range(n):
            stride = (1 if stage == 0 else 2) if i == 0 else 1
            out.append((stage, f"layer{stage + 1}_block{i}", cin, c, stride))
            cin = c
    return out


def encoder_dim(num_layers: int) -> int:
    return 64 + sum(STAGES[i][1] for i in range(num_layers - 1))


def pe_dim(num_frequencies: int) -> int:
    return 3 * num_frequencies * 2 + 3


def parameter_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, initial distribution) of every parameter and buffer of
    the model configuration `model` (a configuration file's "model")."""
    enc = model["encoder"]
    spec = [("encoder.conv1.weight", (7, 7, 3, 64), "kaiming_out")] + _bn_spec("encoder.bn1", 64)
    for _, name, cin, c, stride in encoder_blocks(enc["num_layers"]):
        p = f"encoder.{name}"
        spec += [(f"{p}.conv1.weight", (3, 3, cin, c), "kaiming_out")] + _bn_spec(f"{p}.bn1", c)
        spec += [(f"{p}.conv2.weight", (3, 3, c, c), "kaiming_out")] + _bn_spec(f"{p}.bn2", c)
        if stride != 1 or cin != c:
            spec += [(f"{p}.downsample_conv.weight", (1, 1, cin, c), "kaiming_out")]
            spec += _bn_spec(f"{p}.downsample_norm", c)
    latent = encoder_dim(enc["num_layers"])
    dec, act = model["density_decoder"], model["action_decoder"]
    a_dim = model["action_dim"]
    pe = pe_dim(act["num_frequencies"])
    geo = act["geometry_feature_dim"]
    spec += _trunk_spec("decoder.density_head", act["mlp"], pe, geo + 1, latent, False)
    if act["name"] == "jacobian_mlp":
        spec += _trunk_spec("decoder.jacobian_head", act["mlp"], pe, 3 * a_dim, latent, True)
    elif act["name"] == "jacobian_transformer":
        t = act["transformer"]
        d, inner = t["attn_feat_dim"], t["attn_head_dim"] * t["num_attn_heads"]
        spec.append(("decoder.jacobian_index_embedding", (1, a_dim, d), "normal"))
        spec += _linear_spec("decoder.jacobian_query_mlp", pe + latent, d, "torch_linear")
        p = "decoder.jacobian_attn_decoder"
        for i in range(t["attn_depth"]):
            spec += [(f"{p}.layers_{i}_attn_norm.weight", (d,), "ones"),
                     (f"{p}.layers_{i}_attn_norm.bias", (d,), "zeros")]
            spec += _linear_spec(f"{p}.layers_{i}_attn.to_q", d, inner, "torch_linear", False)
            spec += _linear_spec(f"{p}.layers_{i}_attn.to_kv", d, 2 * inner, "torch_linear",
                                 False)
            spec += _linear_spec(f"{p}.layers_{i}_attn.to_out", inner, d, "torch_linear")
            spec += [(f"{p}.layers_{i}_ff_norm.weight", (d,), "ones"),
                     (f"{p}.layers_{i}_ff_norm.bias", (d,), "zeros")]
            spec += _linear_spec(f"{p}.layers_{i}_ff.fc1", d, t["attn_mlp_dim"], "torch_linear")
            spec += _linear_spec(f"{p}.layers_{i}_ff.fc2", t["attn_mlp_dim"], d, "torch_linear")
        spec += _linear_spec("decoder.jacobian_head", d, 3 * a_dim, "near_zero")
    else:
        raise ValueError(f"no reference for the action decoder {act['name']!r}")
    spec += _linear_spec("decoder.color_head.fc1", geo + 16, 64, "torch_linear")
    spec += _linear_spec("decoder.color_head.fc2", 64, 64, "torch_linear")
    spec += _linear_spec("decoder.color_head.fc3", 64, 3, "torch_linear")
    for i in range(len(model["rendering"]["num_proposal_samples"])):
        spec += _trunk_spec(f"proposal_networks_{i}.density_head", dec["mlp"],
                            pe_dim(dec["num_frequencies"]), 1, latent, False)
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


def trainable(name: str, model: dict, mode: str) -> bool:
    """Stage 1 trains every parameter; stage 2 the decoder's action heads
    (the names that hold the decoder's action pattern)."""
    if is_buffer(name):
        return False
    if mode == "perception":
        return True
    pattern = {"jacobian_mlp": "jacobian_head",
               "jacobian_transformer": "jacobian"}[model["action_decoder"]["name"]]
    parts = name.split(".")
    return parts[0] == "decoder" and any(pattern in part for part in parts)


# ------------------------------------------------------------------ geometry

def inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(m).inverse


def world_to_cam(x: torch.Tensor, cam2world: torch.Tensor) -> torch.Tensor:
    """x [..., 3] world -> camera space by the inverse of cam2world [..., 4, 4]."""
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return torch.einsum("...ij,...j->...i", inverse(cam2world), xh)[..., :3]


def project(cam: torch.Tensor, intrinsics: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    xyw = torch.einsum("...ij,...j->...i", intrinsics, cam)
    return xyw / (xyw[..., 2:] + eps)


def pixel_rays(yx: torch.Tensor, h: int, w: int, intrinsics: torch.Tensor,
               cam2world: torch.Tensor):
    """Rays through pixel centres yx [R, 2] of each camera: origins and unit
    directions [B, R, 3] and the directions' camera-space z [B, R, 1]."""
    b = intrinsics.shape[0]
    xy = torch.stack([(yx[:, 1].float() + 0.5) / w, (yx[:, 0].float() + 0.5) / h], dim=-1)
    xy = xy[None].expand(b, -1, -1)
    return rays_from_coords(xy, intrinsics, cam2world)


def rays_from_coords(xy: torch.Tensor, intrinsics: torch.Tensor, cam2world: torch.Tensor):
    xyh = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    d = torch.einsum("bij,bnj->bni", inverse(intrinsics), xyh)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = d[..., 2:]
    dw = torch.einsum("bij,bnj->bni", cam2world[:, :3, :3], d)
    o = cam2world[:, None, :3, 3].expand_as(dw)
    return o, dw, z


def to_pixels(intrinsics: torch.Tensor, h: int, w: int) -> torch.Tensor:
    scale = torch.tensor([[w, 1.0, w], [1.0, h, h], [1.0, 1.0, 1.0]], device=intrinsics.device)
    return intrinsics * scale


# ------------------------------------------------------------------- encoder

def _conv(x, w, stride, pad, q):
    """NHWC x, HWIO w."""
    y = F.conv2d(q(x).permute(0, 3, 1, 2), q(w).permute(3, 2, 0, 1), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def _batch_norm(p, prefix, y, train, updates, momentum=0.9):
    if train:
        mean = y.mean(dim=(0, 1, 2))
        var = torch.clamp((y * y).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
        for key, batch in (("running_mean", mean), ("running_var", var)):
            k = f"{prefix}.{key}"
            updates[k] = momentum * p[k] + (1.0 - momentum) * batch.detach()
    else:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    return (y - mean) * (torch.rsqrt(var + 1e-5) * p[f"{prefix}.weight"]) + p[f"{prefix}.bias"]


def encode(p: Dict[str, torch.Tensor], rgb: torch.Tensor, num_layers: int, train: bool,
           q: Precision, updates: Dict[str, torch.Tensor], momentum: float = 0.9):
    """rgb [B, H, W, 3] -> (fine [B, H/2, W/2, 128], mid, coarse) pyramid
    levels; `updates` receives the BatchNorm running statistics in training
    mode (momentum 0: the batch's own)."""

    def bn(prefix, y):
        return _batch_norm(p, prefix, y, train, updates, momentum)

    x = torch.relu(bn("encoder.bn1", _conv(rgb, p["encoder.conv1.weight"], 2, 3, q)))
    latents = [x]
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    stage = 0
    for st, name, cin, c, stride in encoder_blocks(num_layers):
        if st != stage:
            latents.append(x)
            stage = st
        pre = f"encoder.{name}"
        y = torch.relu(bn(f"{pre}.bn1", _conv(x, p[f"{pre}.conv1.weight"], stride, 1, q)))
        y = bn(f"{pre}.bn2", _conv(y, p[f"{pre}.conv2.weight"], 1, 1, q))
        res = x
        if stride != 1 or cin != c:
            xs = x[:, ::stride, ::stride]
            res = bn(f"{pre}.downsample_norm", q(xs) @ q(p[f"{pre}.downsample_conv.weight"][0, 0]))
        x = torch.relu(y + res)
    latents.append(x)
    hw = latents[0].shape[1:3]
    up = F.interpolate(latents[1].permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    return torch.cat([latents[0], up], dim=-1), latents[2], latents[3]


# ---------------------------------------------------------- epipolar features

def bilinear(level: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Border-clamped bilinear samples of level [B, H, W, C] at pixel coords
    x, y [B, N] -> [B, N, C]."""
    b, h, w, c = level.shape
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, w - 1)
    y = torch.clamp(torch.nan_to_num(y, nan=0.0), 0.0, h - 1)
    x0 = torch.clamp(torch.floor(x), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y), 0, max(h - 2, 0))
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = level.reshape(b, h * w, c)
    base = (y0 * w + x0).long()

    def take(idx):
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

    return ((1 - wy) * ((1 - wx) * take(base) + wx * take(base + 1))
            + wy * ((1 - wx) * take(base + w) + wx * take(base + w + 1)))


def clip_segment(p0, p1, width: float, height: float):
    """Clip 2D segments to the box [-1, width] x [-1, height]; a segment
    that misses the box keeps its ends."""
    d = p1 - p0
    lo = torch.full_like(p0, -1.0)
    hi = torch.stack([torch.full_like(p0[..., 0], width), torch.full_like(p0[..., 0], height)],
                     dim=-1)
    parallel = torch.abs(d) < 1e-9
    sd = torch.where(parallel, torch.full_like(d, 1e-9), d)
    ta, tb = (lo - p0) / sd, (hi - p0) / sd
    tmin, tmax = torch.minimum(ta, tb), torch.maximum(ta, tb)
    outside = (p0 < lo) | (p0 > hi)
    inf = torch.full_like(d, float("inf"))
    tmin = torch.where(parallel, torch.where(outside, inf, -inf), tmin)
    tmax = torch.where(parallel, torch.where(outside, -inf, inf), tmax)
    t0 = torch.clamp(tmin.amax(dim=-1), 0.0, 1.0)
    t1 = torch.clamp(tmax.amin(dim=-1), 0.0, 1.0)
    valid = t1 > t0
    t0 = torch.where(valid, t0, torch.zeros_like(t0))[..., None]
    t1 = torch.where(valid, t1, torch.ones_like(t1))[..., None]
    return p0 + t0 * d, p0 + t1 * d


@dataclass
class Knots:
    levels: Tuple[torch.Tensor, ...]  # [B, R, M_l, C_l]
    p0: torch.Tensor  # [B, R, 2] fine pixels
    pdir: torch.Tensor
    inv_len2: torch.Tensor  # [B, R, 1]
    fine_hw: Tuple[int, int]


def ray_knots(pyramid, origins, directions, near, far, cam2world, intrinsics,
              num_knots) -> Knots:
    """Each ray's [near, far] span projected into the context camera, clipped,
    and sampled at num_knots evenly spaced knots on every level."""
    fine, mid, coarse = pyramid
    hf, wf = fine.shape[1:3]
    ends = torch.stack([origins + near[..., None] * directions,
                        origins + far[..., None] * directions], dim=2)  # [B, R, 2, 3]
    cam = world_to_cam(ends, cam2world[:, None, None])
    cam = torch.cat([cam[..., :2], torch.clamp(cam[..., 2:], min=1e-6)], dim=-1)
    uv = project(cam, intrinsics[:, None, None])
    px = torch.stack([uv[..., 0] * (wf - 1), uv[..., 1] * (hf - 1)], dim=-1)
    p0, p1 = clip_segment(px[:, :, 0], px[:, :, 1], float(wf - 1), float(hf - 1))
    pdir = p1 - p0
    inv_len2 = 1.0 / torch.clamp(torch.sum(pdir * pdir, dim=-1, keepdim=True), min=1e-8)
    levels = []
    b, r = p0.shape[:2]
    for level, m in zip((fine, mid, coarse), num_knots):
        stride = (hf + level.shape[1] - 1) // level.shape[1]
        frac = torch.linspace(0.0, 1.0, m, device=p0.device)
        pk = p0[:, :, None, :] + frac[None, None, :, None] * pdir[:, :, None, :]
        lx = (pk[..., 0] + 0.5) / stride - 0.5
        ly = (pk[..., 1] + 0.5) / stride - 0.5
        s = bilinear(level, lx.reshape(b, r * m), ly.reshape(b, r * m))
        levels.append(s.reshape(b, r, m, -1))
    return Knots(tuple(levels), p0, pdir, inv_len2, (hf, wf))


def knot_features(knots: Knots, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Samples at fine-pixel projections fx, fy [B, R*S]: each level's two
    neighbouring knots interpolated at the sample's place on the segment,
    levels concatenated -> [B, R*S, C]."""
    b, n = fx.shape
    r = knots.p0.shape[1]
    pt = torch.stack([fx, fy], dim=-1).reshape(b, r, n // r, 2)
    s = torch.sum((pt - knots.p0[:, :, None]) * knots.pdir[:, :, None], dim=-1)
    s = torch.clamp(s * knots.inv_len2, 0.0, 1.0).detach()  # [B, R, S]
    out = []
    for level in knots.levels:
        m, c = level.shape[2], level.shape[3]
        pos = s * (m - 1)
        k0 = torch.clamp(torch.floor(pos), 0, m - 2)
        w = (pos - k0)[..., None]
        k0 = k0.long()

        def take(k):
            return torch.gather(level, 2, k[..., None].expand(-1, -1, -1, c))

        out.append(((1 - w) * take(k0) + w * take(k0 + 1)).reshape(b, n, c))
    return torch.cat(out, dim=-1)


# -------------------------------------------------------------------- fields

def positional_encoding(x: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    freqs = 2.0 ** torch.linspace(0.0, num_frequencies - 1.0, num_frequencies,
                                  device=x.device)
    scaled = ((2.0 * math.pi) * x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(torch.cat([scaled, scaled + 0.5 * math.pi], dim=-1)), x],
                     dim=-1)


def sh_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree < 4 (16 values) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y,
        0.48860251190291987 * z, -0.48860251190291987 * x, 1.0925484305920792 * xy,
        -1.0925484305920792 * yz, 0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], dim=-1)


def linear(p, name, x, q):
    return F.linear(q(x), q(p[f"{name}.weight"]), p.get(f"{name}.bias"))


def trunk_features(p, prefix: str, mlp: dict, z: torch.Tensor, x: torch.Tensor,
                   q) -> torch.Tensor:
    """ResnetFC up to its output layer: h = lin_in(x); block i adds
    lin_z_i(z) first (i < combine_layer), then h += fc_1(relu(fc_0(relu(h))));
    returns relu(h)."""
    h = linear(p, f"{prefix}.lin_in", x, q)
    for i in range(mlp["n_blocks"]):
        if i < mlp["combine_layer"]:
            h = h + linear(p, f"{prefix}.lin_z_{i}", z, q)
        net = linear(p, f"{prefix}.blocks_{i}_fc_0", torch.relu(h), q)
        h = h + linear(p, f"{prefix}.blocks_{i}_fc_1", torch.relu(net), q)
    return torch.relu(h)


def trunk(p, prefix: str, mlp: dict, z: torch.Tensor, x: torch.Tensor, q) -> torch.Tensor:
    """ResnetFC: lin_out of `trunk_features`."""
    return linear(p, f"{prefix}.lin_out", trunk_features(p, prefix, mlp, z, x, q), q)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) whose gradient is taken at x clamped to [-15, 15]."""
    return torch.exp(x).detach() + (torch.exp(torch.clamp(x, -15.0, 15.0))
                                   * (x - x.detach()))


def layer_norm(p, prefix, x):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + 1e-6) * p[f"{prefix}.weight"]) + p[f"{prefix}.bias"]


def transformer_jacobian(p, t: dict, query: torch.Tensor, q) -> torch.Tensor:
    """query [B, N, pe + latent] -> Jacobian [B, N, 3A]: one token a point
    cross-attends, layer by layer (pre-norm, exact GELU), into the learned
    index embeddings; a linear head reads the token."""
    pre = "decoder.jacobian_attn_decoder"
    heads, dh = t["num_attn_heads"], t["attn_head_dim"]
    x = linear(p, "decoder.jacobian_query_mlp", query, q)
    z = p["decoder.jacobian_index_embedding"]

    def split(v):
        return v.reshape(*v.shape[:-1], heads, dh).transpose(-3, -2)

    for i in range(t["attn_depth"]):
        a = f"{pre}.layers_{i}_attn"
        xn = layer_norm(p, f"{pre}.layers_{i}_attn_norm", x)
        qq = split(linear(p, f"{a}.to_q", xn, q))
        k, v = linear(p, f"{a}.to_kv", z, q).chunk(2, dim=-1)
        k, v = split(k), split(v)
        att = torch.softmax(torch.matmul(q(qq), q(k).transpose(-1, -2)) * dh ** -0.5, dim=-1)
        o = torch.matmul(q(att), q(v)).transpose(-3, -2)
        x = x + linear(p, f"{a}.to_out", o.reshape(*o.shape[:-2], heads * dh), q)
        f = f"{pre}.layers_{i}_ff"
        xn = layer_norm(p, f"{pre}.layers_{i}_ff_norm", x)
        x = x + linear(p, f"{f}.fc2", F.gelu(linear(p, f"{f}.fc1", xn, q)), q)
    return linear(p, "decoder.jacobian_head", x, q)


# ------------------------------------------------------------------- sampling

@dataclass
class Samples:
    bins: torch.Tensor  # [B, R, S+1] spacing-domain edges
    starts: torch.Tensor  # [B, R, S] euclidean
    ends: torch.Tensor

    @property
    def deltas(self):
        return self.ends - self.starts

    def positions(self, o, d):
        return o[:, :, None] + d[:, :, None] * ((self.starts + self.ends) / 2)[..., None]


def samples_from_bins(bins, near, far) -> Samples:
    e = bins * far[..., None] + (1 - bins) * near[..., None]
    return Samples(bins, e[..., :-1], e[..., 1:])


def spaced_bins(shape, n, jitter: Optional[torch.Tensor], device) -> torch.Tensor:
    bins = torch.linspace(0.0, 1.0, n + 1, device=device).expand(*shape, n + 1)
    if jitter is None:
        return bins
    centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
    upper = torch.cat([centers, bins[..., -1:]], dim=-1)
    lower = torch.cat([bins[..., :1], centers], dim=-1)
    return lower + (upper - lower) * jitter


def resample(bins, weights, n, jitter: Optional[torch.Tensor], padding: float = 0.01,
             eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF resampling of the bin edges by the weights (histogram
    padded), at a regular grid of n + 1 queries, each jittered within its
    cell by `jitter` or at the cell centre."""
    nb = n + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / nb, nb, device=bins.device).expand(*bins.shape[:-1], nb)
    u = u + (jitter / nb if jitter is not None else 0.5 / nb)
    w = weights + padding
    ws = torch.sum(w, dim=-1, keepdim=True)
    pad = torch.relu(eps - ws)
    w = w + pad / w.shape[-1]
    cdf = torch.clamp(torch.cumsum(w / (ws + pad), dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    top = bins.shape[-1] - 1
    below, above = torch.clamp(inds - 1, 0, top), torch.clamp(inds, 0, top)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = c1 - c0
    t = torch.where(den > 0, (u - c0) / torch.where(den > 0, den, torch.ones_like(den)),
                    torch.zeros_like(den))
    t = torch.clamp(torch.nan_to_num(t, nan=0.0), 0.0, 1.0)
    return (b0 + t * (b1 - b0)).detach()


def render_weights(density: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """density, deltas [..., S] -> the alpha-compositing weights [..., S]."""
    dd = torch.where(deltas > 0, deltas * density, torch.zeros_like(density))
    acc = torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], dim=-1)], dim=-1)
    return (1.0 - torch.exp(-dd)) * torch.exp(-acc)
