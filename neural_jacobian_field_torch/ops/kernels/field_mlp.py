"""K7: the fused ResnetFC trunk — CUDA kernels for its forward and backward
in two modes, their plain versions, and the differentiable entry points.

Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py:
  - `fused_resnet_fc_train`, a custom_vjp over `_k7_fwd` (K7-fwd) and
    `_k7_bwd` (K7-bwd): the latent z [..., d_latent], or a tuple of levels
    whose widths sum to d_latent, is projected by the lin_z kernels INSIDE the
    kernel (projection mode; the exact feature path);
  - `fused_resnet_fc_train_tz`, over `_k7tz_fwd` (K7-tz-fwd) and `_k7tz_bwd`
    (K7-tz-bwd): tz [..., n_lin_z * d_hidden] = lin_z(z) without bias arrives
    precomputed (knot-side projection; the epipolar path), and the lin_z
    entries of `params` carry their bias only.
`params` is the trunk's parameter dict in the Flax layout ({layer: {"kernel":
[in, out], "bias": [out]}}), x [..., d_in] the positional encoding; the
result is [..., d_out] float32.

Numerics follow the TPU kernels exactly: bf16 operands, f32 accumulation,
every layer output cast to bf16 (`_forward_tile`); the injection is bf16(t +
b_z) with t the float32 projection sum (or the bf16 tz). The backward takes
the upstream gradient in bf16, recomputes the forward, keeps dx and every
dW/db in float32, gives dz in each level's own dtype (dz = bf16(dt) W_z^T
summed in float32) and gives x no gradient. The kernels (csrc/field_mlp.cu,
csrc/field_mlp_bwd.cu) say in their headers what bounds them.

The forward kernels run by `fwd_plan`: the flagship's shapes (d_hidden 128,
d_in <= 64, latent levels in multiples of 64) take the persistent wgmma
kernel, which reads a forward-only packing of the weights (`_pack_fwd`) and
x_pe padded to 64 columns; other shapes take the legacy WMMA kernel, counted
apart in each forward wrapper's `legacy_launches`. The backward kernels read
`_pack`'s layout.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version. The Functions look their wrappers up in this
module at call time, so swapping a wrapper for its plain version here swaps
it for the forward and the backward alike.
"""

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of
from .conv_suite import SMS, _count, _on_device, _sms

_BF = torch.bfloat16


def _n_lin_z(cfg) -> int:
    return min(cfg.combine_layer, cfg.n_blocks)


def _bias_z(params, cfg, device) -> torch.Tensor:
    n = _n_lin_z(cfg)
    if n == 0:
        return torch.zeros(0, device=device)
    return torch.cat([params[f"lin_z_{i}"]["bias"] for i in range(n)])


def _levels(z):
    return list(z) if isinstance(z, (tuple, list)) else [z]


def _rb(a: torch.Tensor) -> torch.Tensor:
    """The bf16 value of a, in float32."""
    return a.to(_BF).float()


# ---------------------------------------------------------------- plain versions

def _injection_plain(params, cfg, n, tz=None, z=None):
    """The injection operand [N, n_lin_z * d_hidden] (bf16 values): tz mode
    bf16(bf16(tz) + b_z); projection mode bf16(sum_l bf16(z_l) @ W_z[rows of
    level l] + b_z), the levels' products summed in order as _forward_tile
    does. None without injection."""
    n_lin_z = _n_lin_z(cfg)
    if n_lin_z == 0:
        return None
    device = (tz if tz is not None else _levels(z)[0]).device
    bz = _rb(_bias_z(params, cfg, device))
    if tz is not None:
        return _rb(_rb(tz.reshape(n, -1)) + bz)
    wz = torch.cat([_rb(params[f"lin_z_{i}"]["kernel"]) for i in range(n_lin_z)], dim=1)
    acc, r = None, 0
    for zl in _levels(z):
        d = zl.shape[-1]
        term = _rb(zl.reshape(n, d)) @ wz[r:r + d]
        acc = term if acc is None else acc + term
        r += d
    return _rb(acc + bz)


def _trunk_plain(params, cfg, inj, x2):
    """The trunk's residual chain: (final x, [(block input x_i, net_i)])."""
    dh = cfg.d_hidden
    n_lin_z = _n_lin_z(cfg)

    def w(name):
        return _rb(params[name]["kernel"])

    def b(name):
        return _rb(params[name]["bias"])

    h = _rb(_rb(x2) @ w("lin_in") + b("lin_in"))
    saved = []
    for i in range(cfg.n_blocks):
        if inj is not None and i < n_lin_z:
            h = _rb(h + inj[:, i * dh:(i + 1) * dh])
        net = _rb(torch.relu(h) @ w(f"blocks_{i}_fc_0") + b(f"blocks_{i}_fc_0"))
        saved.append((h, net))
        h = _rb(h + _rb(torch.relu(net) @ w(f"blocks_{i}_fc_1") + b(f"blocks_{i}_fc_1")))
    return h, saved


def _forward_plain(params, cfg, inj, x, d_out):
    x2 = x.reshape(-1, x.shape[-1])
    h, _ = _trunk_plain(params, cfg, inj, x2)
    out = _rb(torch.relu(h)) @ _rb(params["lin_out"]["kernel"]) + _rb(params["lin_out"]["bias"])
    return out.reshape(*x.shape[:-1], d_out)


def _trunk_bwd_plain(params, cfg, inj, x2, g2):
    """The recompute-backward (_make_bwd_kernel): the trunk's float32 dW/db
    and the float32 gradient of each injected block's input, in block order."""
    n_lin_z = _n_lin_z(cfg)

    def w(name):
        return _rb(params[name]["kernel"])

    h, saved = _trunk_plain(params, cfg, inj, x2)
    grads = {"lin_out": {"kernel": torch.relu(h).t() @ g2, "bias": g2.sum(0)}}
    dx = (g2 @ w("lin_out").t()) * (h > 0)
    dts = []
    for i in reversed(range(cfg.n_blocks)):
        x_in, net = saved[i]
        fc0, fc1 = f"blocks_{i}_fc_0", f"blocks_{i}_fc_1"
        grads[fc1] = {"kernel": torch.relu(net).t() @ _rb(dx), "bias": dx.sum(0)}
        dnet = (_rb(dx) @ w(fc1).t()) * (net > 0)
        grads[fc0] = {"kernel": torch.relu(x_in).t() @ _rb(dnet), "bias": dnet.sum(0)}
        dx = dx + (_rb(dnet) @ w(fc0).t()) * (x_in > 0)
        if i < n_lin_z:
            dts.insert(0, dx)
    for i, d in enumerate(dts):
        grads[f"lin_z_{i}"] = {"bias": d.sum(0)}
    grads["lin_in"] = {"kernel": _rb(x2).t() @ _rb(dx), "bias": dx.sum(0)}
    return grads, dts


def fused_resnet_fc_tz_plain(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                             d_out: int) -> torch.Tensor:
    """Plain PyTorch version of the tz-mode trunk (the TPU kernel's
    _forward_tile with a precomputed tz)."""
    _check_tz(tz, cfg)
    n = x.reshape(-1, x.shape[-1]).shape[0]
    return _forward_plain(params, cfg, _injection_plain(params, cfg, n, tz=tz), x, d_out)


def fused_resnet_fc_tz_bwd_plain(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                                 g: torch.Tensor, d_out: int):
    """Plain PyTorch version of the tz-mode backward (the TPU kernel's
    _make_bwd_kernel in tz mode): returns (dparams in the params' layout,
    float32; dtz in tz's dtype). x gets no gradient."""
    x2 = x.reshape(-1, x.shape[-1])
    inj = _injection_plain(params, cfg, x2.shape[0], tz=tz)
    grads, dts = _trunk_bwd_plain(params, cfg, inj, x2, _rb(g.reshape(-1, d_out)))
    dtz = (torch.cat(dts, dim=-1) if dts
           else torch.zeros((x2.shape[0], 0), device=x2.device))
    return grads, dtz.to(tz.dtype).reshape(tz.shape)


def fused_resnet_fc_plain(params, cfg, z, x: torch.Tensor, d_out: int) -> torch.Tensor:
    """Plain PyTorch version of the projection-mode trunk (the TPU kernel's
    _forward_tile with the latent projection): z one array or a tuple of
    levels."""
    n = x.reshape(-1, x.shape[-1]).shape[0]
    return _forward_plain(params, cfg, _injection_plain(params, cfg, n, z=z), x, d_out)


def fused_resnet_fc_bwd_plain(params, cfg, z, x: torch.Tensor, g: torch.Tensor, d_out: int):
    """Plain PyTorch version of the projection-mode backward: returns
    (dparams in the params' layout, float32, the lin_z kernels included; dz
    with z's structure, each level in its own dtype). x gets no gradient."""
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    levels = _levels(z)
    inj = _injection_plain(params, cfg, n, z=z)
    grads, dts = _trunk_bwd_plain(params, cfg, inj, x2, _rb(g.reshape(-1, d_out)))
    dh = cfg.d_hidden
    if dts:
        dt = _rb(torch.cat(dts, dim=-1))
        wz = torch.cat([_rb(params[f"lin_z_{i}"]["kernel"]) for i in range(len(dts))], dim=1)
        dwz, dzs, r = [], [], 0
        for zl in levels:
            d = zl.shape[-1]
            dwz.append(_rb(zl.reshape(n, d)).t() @ dt)
            dzs.append((dt @ wz[r:r + d].t()).to(zl.dtype).reshape(zl.shape))
            r += d
        dwz = torch.cat(dwz, dim=0)
        for i in range(len(dts)):
            grads[f"lin_z_{i}"]["kernel"] = dwz[:, i * dh:(i + 1) * dh]
    else:
        dzs = [torch.zeros_like(zl) for zl in levels]
    return grads, (tuple(dzs) if isinstance(z, (tuple, list)) else dzs[0])


# ------------------------------------------------------------ the forward plan

class FwdPlan(NamedTuple):
    """How K7-fwd / K7-tz-fwd run one shape (csrc/field_mlp.cu). legacy: the
    WMMA kernel, one block per `tile` = 64 points. Otherwise the wgmma
    kernel: `grid` persistent blocks walk the `n_tiles` tiles of `tile` =
    128 points (block b takes tiles b, b + grid, ...), `consumers` warpgroups
    of 64 points each and one producer warpgroup, a ring of `stages` stages
    of `stage_bytes` (the weights of one step, at most [128, 128] bf16, and
    each consumer's input tiles, at most 64 points x 128 bf16), `smem` bytes
    of dynamic shared memory in all (the ring, the biases, the barriers and
    1,024 bytes of alignment slack)."""
    legacy: bool
    tile: int
    n_tiles: int
    grid: int
    consumers: int
    stages: int
    stage_bytes: int
    smem: int

    def tiles(self, block: int) -> range:
        """The tiles block `block` computes, in order."""
        return range(block, self.n_tiles, self.grid)


FWD_DH, FWD_K_IN, FWD_OUT_COLS = 128, 64, 64  # the wgmma kernel's widths
FWD_SMEM_MAX = 232448  # shared memory a block may use on the H100


def fwd_bias_floats(n_blocks: int, n_lin_z: int) -> int:
    """Length of `_pack_fwd`'s bias vector."""
    return FWD_DH * (1 + n_lin_z + 2 * n_blocks) + FWD_OUT_COLS


@functools.lru_cache(maxsize=256)
def fwd_plan(n: int, d_in: int, dh: int, n_blocks: int, n_lin_z: int, d_out: int,
             widths: tuple | None = None, sms: int = SMS) -> FwdPlan:
    """The plan of one trunk forward over n points; `widths` the latent
    levels' widths (projection mode) or None (tz mode). The wgmma kernel
    takes d_hidden 128, d_in <= 64, d_out <= 64, 1 to 3 levels each a
    multiple of 64 wide, and what fits its shared memory; one block per SM
    (of `sms`), fewer when there are fewer tiles. Anything else takes the
    legacy kernel."""
    consumers, stages = 2, 3
    stage_bytes = FWD_DH * FWD_DH * 2 + consumers * 64 * FWD_DH * 2
    smem = 1024 + stages * stage_bytes + 4 * fwd_bias_floats(n_blocks, n_lin_z) + 16 * stages
    ok = (dh == FWD_DH and 0 < d_in <= FWD_K_IN and 0 < d_out <= FWD_OUT_COLS
          and 0 <= n_lin_z <= n_blocks and smem <= FWD_SMEM_MAX
          and (widths is None or (1 <= len(widths) <= 3
                                  and all(w > 0 and w % 64 == 0 for w in widths))))
    if not ok:
        n_tiles = -(-n // 64)
        return FwdPlan(True, 64, n_tiles, n_tiles, 0, 0, 0, 0)
    n_tiles = -(-n // 128)
    return FwdPlan(False, 128, n_tiles, max(1, min(n_tiles, sms)), consumers, stages,
                   stage_bytes, smem)


def fwd_weight_rows(n_blocks: int, n_lin_z: int, d_lat: int = 0) -> list:
    """The rows of `_pack_fwd`'s weight matrix [rows, 128], in order: (layer,
    first row, rows). W_in padded to 64 rows, W0 and W1 of each block,
    W_out (its columns padded to 128), then in projection mode (d_lat > 0)
    lin_z_i's kernel [d_lat, 128] for i < n_lin_z."""
    rows, r = [], 0
    for layer, k in ([("lin_in", FWD_K_IN)]
                     + [(f"blocks_{i}_fc_{j}", FWD_DH) for i in range(n_blocks) for j in (0, 1)]
                     + [("lin_out", FWD_DH)]
                     + [(f"lin_z_{i}", d_lat) for i in range(n_lin_z if d_lat else 0)]):
        rows.append((layer, r, k))
        r += k
    return rows


def _pack_fwd(params, cfg, d_in: int, d_out: int, device, projection: bool):
    """The wgmma kernel's weights and biases: one bf16 [rows, 128] matrix in
    the order of `fwd_weight_rows` (zero rows after d_in in W_in, zero
    columns after d_out in W_out), and the float32 biases (bf16 values)
    b_in, b_z, per block b0 and b1, then b_out padded to 64."""
    n_lin_z = _n_lin_z(cfg)
    mats = [F.pad(params["lin_in"]["kernel"], (0, 0, 0, FWD_K_IN - d_in))]
    for i in range(cfg.n_blocks):
        mats += [params[f"blocks_{i}_fc_0"]["kernel"], params[f"blocks_{i}_fc_1"]["kernel"]]
    mats.append(F.pad(params["lin_out"]["kernel"], (0, FWD_DH - d_out)))
    if projection:
        mats += [params[f"lin_z_{i}"]["kernel"] for i in range(n_lin_z)]
    biases = [params["lin_in"]["bias"]] + [params[f"lin_z_{i}"]["bias"] for i in range(n_lin_z)]
    for i in range(cfg.n_blocks):
        biases += [params[f"blocks_{i}_fc_0"]["bias"], params[f"blocks_{i}_fc_1"]["bias"]]
    biases.append(F.pad(params["lin_out"]["bias"], (0, FWD_OUT_COLS - d_out)))
    # one concatenation and one cast each (a few launches: this runs per call)
    w = torch.cat(mats).to(device=device, dtype=_BF)
    b = torch.cat(biases).to(device=device, dtype=_BF).float()
    return w, b


def _pad_x(x: torch.Tensor, d_in: int) -> torch.Tensor:
    """x_pe as the wgmma kernel reads it: a bf16 [N, 64] copy, zeros after
    column d_in (126-byte rows cannot be a TMA map)."""
    return F.pad(x.reshape(-1, d_in).to(_BF), (0, FWD_K_IN - d_in)).contiguous()


# ------------------------------------------------------------------ CUDA wrappers

def _pack(params, cfg, d_in: int, d_out: int, device):
    """Weights and biases into the kernels' packed layout
    (csrc/field_mlp_common.cuh)."""
    dh = cfg.d_hidden
    k_in = (d_in + 15) // 16 * 16
    n_out = (d_out + 15) // 16 * 16

    def kern(name):
        return params[name]["kernel"].to(device=device, dtype=_BF)

    def bias(name):
        return params[name]["bias"].to(device=device, dtype=_BF).float()

    w_in = torch.zeros((k_in, dh), dtype=_BF, device=device)
    w_in[:d_in] = kern("lin_in")
    w_out = torch.zeros((dh, n_out), dtype=_BF, device=device)
    w_out[:, :d_out] = kern("lin_out")
    b_out = torch.zeros(n_out, dtype=torch.float32, device=device)
    b_out[:d_out] = bias("lin_out")
    ws, bs = [w_in.reshape(-1)], [bias("lin_in"),
                                  _bias_z(params, cfg, device).to(device=device,
                                                                  dtype=_BF).float()]
    for i in range(cfg.n_blocks):
        for layer in (f"blocks_{i}_fc_0", f"blocks_{i}_fc_1"):
            ws.append(kern(layer).reshape(-1))
            bs.append(bias(layer))
    ws.append(w_out.reshape(-1))
    bs.append(b_out)
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous()


def _check_trunk(name, cfg, d_in, d_out):
    dh = cfg.d_hidden
    if dh not in (32, 64, 128) or not 0 < d_out <= 32 or not 0 < d_in <= 128:
        raise ValueError(f"{name} takes d_hidden in (32, 64, 128), d_out <= 32, "
                         f"d_in <= 128; got {dh}, {d_out}, {d_in}")


def _check_tz(tz, cfg):
    n_lin_z = _n_lin_z(cfg)
    if tz.shape[-1] != n_lin_z * cfg.d_hidden:
        raise ValueError(f"tz width {tz.shape[-1]} != n_lin_z*d_hidden "
                         f"{n_lin_z * cfg.d_hidden}")


def _fused_resnet_fc_tz_cuda(params, cfg, tz, x, d_out):
    lead = tz.shape[:-1]
    d_in = x.shape[-1]
    _check_tz(tz, cfg)
    _check_trunk("K7-tz", cfg, d_in, d_out)
    n = x.numel() // d_in
    if tz.numel() != n * tz.shape[-1]:
        raise ValueError(f"point counts differ: tz {tuple(tz.shape)}, x {tuple(x.shape)}")
    dev = x.device
    out = torch.empty((n, d_out), dtype=torch.float32, device=dev)
    if n == 0:
        return out.reshape(*lead, d_out)
    tz2 = tz.reshape(n, tz.shape[-1]).to(_BF).contiguous()
    check_cuda_tensor(tz2, "K7-tz tz", _BF, 2)
    n_lin_z = _n_lin_z(cfg)
    plan = fwd_plan(n, d_in, cfg.d_hidden, cfg.n_blocks, n_lin_z, d_out, sms=_sms(dev.index))
    lib = load_kernels()
    if plan.legacy:
        x2 = x.reshape(-1, d_in).to(_BF).contiguous()
        check_cuda_tensor(x2, "K7-tz x", _BF, 2)
        wbuf, bbuf = _pack(params, cfg, d_in, d_out, dev)
        with _on_device(x2):
            _count(fused_resnet_fc_tz, True)
            lib.call("njf_field_mlp_tz_fwd", tz2.data_ptr(), x2.data_ptr(),
                     wbuf.data_ptr(), bbuf.data_ptr(), out.data_ptr(), n, d_in, cfg.d_hidden,
                     cfg.n_blocks, n_lin_z, d_out, stream_of(x2))
        return out.reshape(*lead, d_out)
    xp = _pad_x(x, d_in)
    check_cuda_tensor(xp, "K7-tz x", _BF, 2)
    wf, bf = _pack_fwd(params, cfg, d_in, d_out, dev, projection=False)
    with _on_device(xp):
        _count(fused_resnet_fc_tz, False)
        lib.call("njf_field_mlp_tz_fwd_wg", tz2.data_ptr(), xp.data_ptr(), wf.data_ptr(),
                 bf.data_ptr(), out.data_ptr(), n, cfg.n_blocks, n_lin_z, d_out, plan.grid,
                 plan.smem, stream_of(xp))
    return out.reshape(*lead, d_out)


def fused_resnet_fc_tz(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                       d_out: int) -> torch.Tensor:
    """K7-tz-fwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc_tz", x,
                    lambda: _fused_resnet_fc_tz_cuda(params, cfg, tz, x, d_out),
                    lambda: fused_resnet_fc_tz_plain(params, cfg, tz, x, d_out))


def _unpack_grads(flat, params, cfg, d_in: int, d_out: int):
    """The kernel's float32 dW ++ db (the packed layouts of _pack) -> the
    params' layout (lin_z: bias only)."""
    dh, nb = cfg.d_hidden, cfg.n_blocks
    n_lin_z = _n_lin_z(cfg)
    k_in = (d_in + 15) // 16 * 16
    n_out = (d_out + 15) // 16 * 16
    pos = 0

    def take(*shape):
        nonlocal pos
        size = 1
        for d in shape:
            size *= d
        out = flat[pos:pos + size].reshape(shape)
        pos += size
        return out

    grads = {"lin_in": {"kernel": take(k_in, dh)[:d_in]}}
    for i in range(nb):
        grads[f"blocks_{i}_fc_0"] = {"kernel": take(dh, dh)}
        grads[f"blocks_{i}_fc_1"] = {"kernel": take(dh, dh)}
    grads["lin_out"] = {"kernel": take(dh, n_out)[:, :d_out]}
    grads["lin_in"]["bias"] = take(dh)
    bz = take(n_lin_z * dh)
    for i in range(n_lin_z):
        grads[f"lin_z_{i}"] = {"bias": bz[i * dh:(i + 1) * dh]}
    for i in range(nb):
        grads[f"blocks_{i}_fc_0"]["bias"] = take(dh)
        grads[f"blocks_{i}_fc_1"]["bias"] = take(dh)
    grads["lin_out"]["bias"] = take(n_out)[:d_out]
    return grads


def _bwd_scratch(cfg, n, d_in, d_out, dev):
    """The trunk backward's scratch (csrc/field_mlp_bwd.cu): the block-input
    stash, per-block dW and per-warp db partials (zeroed), the reduced dW ++
    db, and the number of persistent blocks (two per SM)."""
    dh, nb = cfg.d_hidden, cfg.n_blocks
    k_in, n_out = (d_in + 15) // 16 * 16, (d_out + 15) // 16 * 16
    w_total = k_in * dh + 2 * nb * dh * dh + dh * n_out
    b_total = dh * (1 + _n_lin_z(cfg) + 2 * nb) + n_out
    n_tiles = -(-n // 64)
    grid = min(n_tiles, 2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    stash = torch.empty((n_tiles * 64, max(nb, 1), dh), dtype=_BF, device=dev)
    wpart = torch.zeros((grid, w_total), dtype=torch.float32, device=dev)
    bpart = torch.zeros((grid * 4, b_total), dtype=torch.float32, device=dev)
    flat = torch.empty(w_total + b_total, dtype=torch.float32, device=dev)
    return stash, wpart, bpart, flat, grid


def _zero_grads(params):
    return {k: {leaf: torch.zeros_like(v, dtype=torch.float32) for leaf, v in p.items()}
            for k, p in params.items()}


def _fused_resnet_fc_tz_bwd_cuda(params, cfg, tz, x, g, d_out):
    d_in = x.shape[-1]
    _check_tz(tz, cfg)
    _check_trunk("K7-tz-bwd", cfg, d_in, d_out)
    x2 = x.reshape(-1, d_in).to(_BF).contiguous()
    n = x2.shape[0]
    if tz.numel() != n * tz.shape[-1] or g.numel() != n * d_out:
        raise ValueError(f"point counts differ: tz {tuple(tz.shape)}, x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)}")
    tz2 = tz.reshape(n, tz.shape[-1]).to(_BF).contiguous()
    g2 = g.reshape(n, d_out).to(_BF).contiguous()
    for t, name in ((tz2, "tz"), (x2, "x"), (g2, "g")):
        check_cuda_tensor(t, f"K7-tz-bwd {name}", _BF, 2)
    dev = x2.device
    dtz = torch.empty((n, tz.shape[-1]), dtype=_BF, device=dev)
    if n == 0:
        return _zero_grads(params), dtz.to(tz.dtype).reshape(tz.shape)
    wbuf, bbuf = _pack(params, cfg, d_in, d_out, dev)
    stash, wpart, bpart, flat, grid = _bwd_scratch(cfg, n, d_in, d_out, dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        fused_resnet_fc_tz_bwd.launches += 1
        lib.call("njf_field_mlp_tz_bwd", tz2.data_ptr(), x2.data_ptr(), g2.data_ptr(),
                 wbuf.data_ptr(), bbuf.data_ptr(), stash.data_ptr(), dtz.data_ptr(),
                 wpart.data_ptr(), bpart.data_ptr(), flat.data_ptr(), n, d_in, cfg.d_hidden,
                 cfg.n_blocks, _n_lin_z(cfg), d_out, grid, stream_of(x2))
    return (_unpack_grads(flat, params, cfg, d_in, d_out),
            dtz.to(tz.dtype).reshape(tz.shape))


def fused_resnet_fc_tz_bwd(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, d_out: int):
    """K7-tz-bwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc_tz_bwd", x,
                    lambda: _fused_resnet_fc_tz_bwd_cuda(params, cfg, tz, x, g, d_out),
                    lambda: fused_resnet_fc_tz_bwd_plain(params, cfg, tz, x, g, d_out))


def _latent_args(params, cfg, z, n, dev, stack: bool = True):
    """The levels as the projection-mode kernels take them: (the [n, c_l]
    arrays, the three pointer / width slots, the float32 mask, W_z packed
    [n_lin_z, d_latent, d_hidden] bf16, or None without injection or
    without `stack`)."""
    levels = _levels(z)
    if not 1 <= len(levels) <= 3:
        raise ValueError(f"K7 takes 1 to 3 latent levels, got {len(levels)}")
    zs = []
    for zl in levels:
        if zl.shape[-1] % 16 or zl.numel() != n * zl.shape[-1]:
            raise ValueError(f"K7 latent level {tuple(zl.shape)}: width must be a multiple "
                             f"of 16 and the point count {n}")
        if zl.dtype not in (_BF, torch.float32):
            raise TypeError(f"K7 latent levels are bfloat16 or float32, got {zl.dtype}")
        z2 = zl.reshape(n, zl.shape[-1]).contiguous()
        check_cuda_tensor(z2, "K7 latent level", zl.dtype, 2)
        zs.append(z2)
    mask = sum(1 << i for i, z2 in enumerate(zs) if z2.dtype == torch.float32)
    ptrs = [z2.data_ptr() for z2 in zs] + [0] * (3 - len(zs))
    widths = [z2.shape[1] for z2 in zs] + [0] * (3 - len(zs))
    n_lin_z = _n_lin_z(cfg)
    for i in range(n_lin_z):
        shape = tuple(params[f"lin_z_{i}"]["kernel"].shape)
        if shape != (sum(widths), cfg.d_hidden):
            raise ValueError(f"lin_z kernels {shape} do not match the latent "
                             f"width {sum(widths)} x d_hidden {cfg.d_hidden}")
    wz = None
    if n_lin_z and stack:
        wz = torch.stack([params[f"lin_z_{i}"]["kernel"].to(device=dev, dtype=_BF)
                          for i in range(n_lin_z)]).contiguous()
    return zs, ptrs, widths, mask, wz


def _fused_resnet_fc_cuda(params, cfg, z, x, d_out):
    d_in = x.shape[-1]
    _check_trunk("K7", cfg, d_in, d_out)
    n = x.numel() // d_in
    dev = x.device
    out = torch.empty((n, d_out), dtype=torch.float32, device=dev)
    if n == 0:
        return out.reshape(*x.shape[:-1], d_out)
    n_lin_z = _n_lin_z(cfg)
    levels = _levels(z)
    plan = fwd_plan(n, d_in, cfg.d_hidden, cfg.n_blocks, n_lin_z, d_out,
                    tuple(zl.shape[-1] for zl in levels), sms=_sms(dev.index))
    zs, ptrs, widths, mask, wz = _latent_args(params, cfg, z, n, dev, stack=plan.legacy)
    lib = load_kernels()
    if plan.legacy:
        x2 = x.reshape(-1, d_in).to(_BF).contiguous()
        check_cuda_tensor(x2, "K7 x", _BF, 2)
        wbuf, bbuf = _pack(params, cfg, d_in, d_out, dev)
        with _on_device(x2):
            _count(fused_resnet_fc, True)
            lib.call("njf_field_mlp_fwd", *ptrs, *widths, len(zs), mask, x2.data_ptr(),
                     wbuf.data_ptr(), 0 if wz is None else wz.data_ptr(), bbuf.data_ptr(),
                     out.data_ptr(), n, d_in, cfg.d_hidden, cfg.n_blocks, n_lin_z, d_out,
                     stream_of(x2))
        return out.reshape(*x.shape[:-1], d_out)
    xp = _pad_x(x, d_in)
    check_cuda_tensor(xp, "K7 x", _BF, 2)
    wf, bf = _pack_fwd(params, cfg, d_in, d_out, dev, projection=True)
    with _on_device(xp):
        _count(fused_resnet_fc, False)
        lib.call("njf_field_mlp_fwd_wg", *ptrs, *widths, len(zs), mask, xp.data_ptr(),
                 wf.data_ptr(), bf.data_ptr(), out.data_ptr(), n, cfg.n_blocks, n_lin_z, d_out,
                 plan.grid, plan.smem, stream_of(xp))
    return out.reshape(*x.shape[:-1], d_out)


def fused_resnet_fc(params, cfg, z, x: torch.Tensor, d_out: int) -> torch.Tensor:
    """K7-fwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc", x,
                    lambda: _fused_resnet_fc_cuda(params, cfg, z, x, d_out),
                    lambda: fused_resnet_fc_plain(params, cfg, z, x, d_out))


def _fused_resnet_fc_bwd_cuda(params, cfg, z, x, g, d_out):
    d_in = x.shape[-1]
    _check_trunk("K7-bwd", cfg, d_in, d_out)
    x2 = x.reshape(-1, d_in).to(_BF).contiguous()
    n = x2.shape[0]
    if g.numel() != n * d_out:
        raise ValueError(f"point counts differ: x {tuple(x.shape)}, g {tuple(g.shape)}")
    g2 = g.reshape(n, d_out).to(_BF).contiguous()
    check_cuda_tensor(x2, "K7-bwd x", _BF, 2)
    check_cuda_tensor(g2, "K7-bwd g", _BF, 2)
    dev = x2.device
    levels = _levels(z)
    dzs = [torch.empty_like(zl, memory_format=torch.contiguous_format) for zl in levels]
    if n == 0:
        grads = _zero_grads(params)
    else:
        zs, ptrs, widths, mask, wz = _latent_args(params, cfg, z, n, dev)
        wbuf, bbuf = _pack(params, cfg, d_in, d_out, dev)
        stash, wpart, bpart, flat, grid = _bwd_scratch(cfg, n, d_in, d_out, dev)
        n_lin_z, dh, d_lat = _n_lin_z(cfg), cfg.d_hidden, sum(widths)
        dt = torch.empty((n, n_lin_z * dh), dtype=_BF, device=dev)
        dwz = torch.empty((n_lin_z, d_lat, dh), dtype=torch.float32, device=dev)
        # dW_z: point ranges for about four blocks of 64 latent rows per SM,
        # each range at least 256 points
        blocks = max(1, -(-d_lat // 64) * n_lin_z)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, min(-(-4 * sms // blocks), n // 256))
        dwz_part = (torch.empty((splits, n_lin_z, d_lat, dh), dtype=torch.float32, device=dev)
                    if splits > 1 else dwz)
        lib = load_kernels()
        with torch.cuda.device(dev):
            fused_resnet_fc_bwd.launches += 1
            lib.call("njf_field_mlp_bwd", *ptrs, *[d.data_ptr() for d in dzs],
                     *[0] * (3 - len(dzs)), *widths, len(zs), mask, x2.data_ptr(),
                     g2.data_ptr(), wbuf.data_ptr(), 0 if wz is None else wz.data_ptr(),
                     bbuf.data_ptr(), stash.data_ptr(), dt.data_ptr(), wpart.data_ptr(),
                     bpart.data_ptr(), flat.data_ptr(), dwz_part.data_ptr(), dwz.data_ptr(),
                     n, d_in, dh, cfg.n_blocks, n_lin_z, d_out, grid, splits, stream_of(x2))
        grads = _unpack_grads(flat, params, cfg, d_in, d_out)
        for i in range(n_lin_z):
            grads[f"lin_z_{i}"]["kernel"] = dwz[i]
    return grads, (tuple(dzs) if isinstance(z, (tuple, list)) else dzs[0])


def fused_resnet_fc_bwd(params, cfg, z, x: torch.Tensor, g: torch.Tensor, d_out: int):
    """K7-bwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc_bwd", x,
                    lambda: _fused_resnet_fc_bwd_cuda(params, cfg, z, x, g, d_out),
                    lambda: fused_resnet_fc_bwd_plain(params, cfg, z, x, g, d_out))


# launches, and for the forward wrappers those among them that went to the
# legacy kernel, which no main-path shape should reach
fused_resnet_fc.launches = 0
fused_resnet_fc_bwd.launches = 0
fused_resnet_fc_tz.launches = 0
fused_resnet_fc_tz_bwd.launches = 0
fused_resnet_fc.legacy_launches = 0
fused_resnet_fc_tz.legacy_launches = 0


# --------------------------------------------------------- autograd.Functions

def _leaf_names(cfg, tz_mode: bool):
    """(layer, leaf) of every trunk parameter, in a fixed order; in tz mode
    the lin_z layers carry their bias only."""
    names = [("lin_in", "kernel"), ("lin_in", "bias")]
    for i in range(_n_lin_z(cfg)):
        if not tz_mode:
            names.append((f"lin_z_{i}", "kernel"))
        names.append((f"lin_z_{i}", "bias"))
    for i in range(cfg.n_blocks):
        for layer in (f"blocks_{i}_fc_0", f"blocks_{i}_fc_1"):
            names += [(layer, "kernel"), (layer, "bias")]
    return names + [("lin_out", "kernel"), ("lin_out", "bias")]


def _as_params(names, leaves):
    params = {}
    for (layer, leaf), t in zip(names, leaves):
        params.setdefault(layer, {})[leaf] = t
    return params


def _leaf_grads(names, grads, leaves):
    return [grads[layer][leaf].to(t.dtype) for (layer, leaf), t in zip(names, leaves)]


class FusedTrunkTz(torch.autograd.Function):
    """The differentiable tz-mode trunk (the JAX fused_resnet_fc_train_tz).
    The weights come in as separate tensor arguments so autograd sees them."""

    @staticmethod
    def forward(ctx, cfg, d_out, tz, x, *leaves):
        ctx.cfg, ctx.d_out = cfg, d_out
        ctx.save_for_backward(tz, x, *leaves)
        return fused_resnet_fc_tz(_as_params(_leaf_names(cfg, True), leaves), cfg, tz, x, d_out)

    @staticmethod
    def backward(ctx, g):
        tz, x, *leaves = ctx.saved_tensors
        names = _leaf_names(ctx.cfg, True)
        grads, dtz = fused_resnet_fc_tz_bwd(_as_params(names, leaves), ctx.cfg, tz, x, g,
                                            ctx.d_out)
        return (None, None, dtz, None, *_leaf_grads(names, grads, leaves))


def fused_resnet_fc_train_tz(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                             d_out: int) -> torch.Tensor:
    """Differentiable tz-mode trunk: K7-tz-fwd forward, K7-tz-bwd backward
    (gradients reach every leaf and tz, never x)."""
    leaves = [params[layer][leaf] for layer, leaf in _leaf_names(cfg, True)]
    return FusedTrunkTz.apply(cfg, d_out, tz, x, *leaves)


class FusedTrunk(torch.autograd.Function):
    """The differentiable projection-mode trunk (the JAX
    fused_resnet_fc_train): the latent levels and the weights come in as
    separate tensor arguments so autograd sees them."""

    @staticmethod
    def forward(ctx, cfg, d_out, n_levels, x, *args):
        levels, leaves = args[:n_levels], args[n_levels:]
        ctx.cfg, ctx.d_out, ctx.n_levels = cfg, d_out, n_levels
        ctx.save_for_backward(x, *levels, *leaves)
        return fused_resnet_fc(_as_params(_leaf_names(cfg, False), leaves), cfg, tuple(levels),
                               x, d_out)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        levels, leaves = rest[:ctx.n_levels], rest[ctx.n_levels:]
        names = _leaf_names(ctx.cfg, False)
        grads, dz = fused_resnet_fc_bwd(_as_params(names, leaves), ctx.cfg, tuple(levels), x, g,
                                        ctx.d_out)
        return (None, None, None, None, *dz, *_leaf_grads(names, grads, leaves))


def fused_resnet_fc_train(params, cfg, z, x: torch.Tensor, d_out: int) -> torch.Tensor:
    """Differentiable projection-mode trunk: K7-fwd forward, K7-bwd backward.
    z is one array or a tuple of levels (the pyramid's fine, mid, coarse);
    gradients reach every leaf and every level, never x."""
    levels = _levels(z)
    leaves = [params[layer][leaf] for layer, leaf in _leaf_names(cfg, False)]
    return FusedTrunk.apply(cfg, d_out, len(levels), x, *levels, *leaves)
