"""K7-tz: the fused ResnetFC trunk with a precomputed latent injection —
CUDA kernels for its forward and backward, their plain versions, and the
differentiable `fused_resnet_fc_train_tz`.

Replaces neural_jacobian_field_tpu/ops/pallas/field_mlp_train.py::
fused_resnet_fc_train_tz, a custom_vjp over `_k7tz_fwd` (K7-tz-fwd) and
`_k7tz_bwd` (K7-tz-bwd). The signature mirrors the JAX function: `params` is
the trunk's parameter dict in the Flax layout ({layer: {"kernel": [in, out],
"bias": [out]}}, the lin_z_* entries with their bias only), tz [..., n_lin_z
* d_hidden] is lin_z(z) without bias, x [..., d_in] the positional encoding;
the result is [..., d_out] float32.

Numerics follow the TPU kernels exactly: bf16 operands, f32 accumulation,
every layer output cast to bf16 (`_forward_tile`); the backward takes the
upstream gradient in bf16, recomputes the forward, keeps dx and every dW/db
in float32 and gives x no gradient. The kernels (csrc/field_mlp_tz.cu,
csrc/field_mlp_tz_bwd.cu) say in their headers what bounds them: the forward
holds each warp's 16 points in shared memory across all 12 layers and
streams the weights layer by layer; the backward recomputes each 64-point
tile, and reduces dW over blocks without atomics.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version. The Function looks its wrappers up in this
module at call time, so swapping a wrapper for its plain version here swaps
it for the forward and the backward alike.
"""

import torch

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of

_BF = torch.bfloat16


def _n_lin_z(cfg) -> int:
    return min(cfg.combine_layer, cfg.n_blocks)


def _bias_z(params, cfg, device) -> torch.Tensor:
    n = _n_lin_z(cfg)
    if n == 0:
        return torch.zeros(0, device=device)
    return torch.cat([params[f"lin_z_{i}"]["bias"] for i in range(n)])


def fused_resnet_fc_tz_plain(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                             d_out: int) -> torch.Tensor:
    """Plain PyTorch version of the trunk (the TPU kernel's _forward_tile)."""
    lead = tz.shape[:-1]
    dh = cfg.d_hidden
    n_lin_z = _n_lin_z(cfg)
    if tz.shape[-1] != n_lin_z * dh:
        raise ValueError(f"tz width {tz.shape[-1]} != n_lin_z*d_hidden {n_lin_z * dh}")

    def w(name):
        return params[name]["kernel"].to(_BF).float()

    def b(name):
        return params[name]["bias"].to(_BF).float()

    def dot(a, wt):
        return a.to(_BF).float() @ wt

    x2 = x.reshape(-1, x.shape[-1])
    h = (dot(x2, w("lin_in")) + b("lin_in")).to(_BF)
    tzb = None
    if n_lin_z > 0:
        bz = _bias_z(params, cfg, tz.device).to(_BF).float()
        tzb = (tz.reshape(-1, tz.shape[-1]).to(_BF).float() + bz).to(_BF)
    for i in range(cfg.n_blocks):
        if tzb is not None and i < n_lin_z:
            h = (h.float() + tzb[:, i * dh:(i + 1) * dh].float()).to(_BF)
        ax = torch.relu(h)
        net = (dot(ax, w(f"blocks_{i}_fc_0")) + b(f"blocks_{i}_fc_0")).to(_BF)
        an = torch.relu(net)
        dx = (dot(an, w(f"blocks_{i}_fc_1")) + b(f"blocks_{i}_fc_1")).to(_BF)
        h = (h.float() + dx.float()).to(_BF)
    out = dot(torch.relu(h), w("lin_out")) + b("lin_out")
    return out.reshape(*lead, d_out)


def fused_resnet_fc_tz_bwd_plain(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                                 g: torch.Tensor, d_out: int):
    """Plain PyTorch version of the backward (the TPU kernel's
    _make_bwd_kernel in tz mode): returns (dparams in the params' layout,
    float32; dtz in tz's dtype). x gets no gradient."""
    dh = cfg.d_hidden
    n_lin_z = _n_lin_z(cfg)

    def w(name):
        return params[name]["kernel"].to(_BF).float()

    def b(name):
        return params[name]["bias"].to(_BF).float()

    def rb(a):  # the bf16 value of a, in float32
        return a.to(_BF).float()

    x2 = x.reshape(-1, x.shape[-1])
    g2 = rb(g.reshape(-1, d_out))
    h = rb(rb(x2) @ w("lin_in") + b("lin_in"))
    tzb = None
    if n_lin_z > 0:
        tzb = rb(rb(tz.reshape(-1, tz.shape[-1])) + rb(_bias_z(params, cfg, tz.device)))
    saved = []
    for i in range(cfg.n_blocks):
        if tzb is not None and i < n_lin_z:
            h = rb(h + tzb[:, i * dh:(i + 1) * dh])
        net = rb(torch.relu(h) @ w(f"blocks_{i}_fc_0") + b(f"blocks_{i}_fc_0"))
        saved.append((h, net))
        h = rb(h + rb(torch.relu(net) @ w(f"blocks_{i}_fc_1") + b(f"blocks_{i}_fc_1")))

    grads = {"lin_out": {"kernel": torch.relu(h).t() @ g2, "bias": g2.sum(0)}}
    dx = (g2 @ w("lin_out").t()) * (h > 0)
    dtz = []
    for i in reversed(range(cfg.n_blocks)):
        x_in, net = saved[i]
        fc0, fc1 = f"blocks_{i}_fc_0", f"blocks_{i}_fc_1"
        grads[fc1] = {"kernel": torch.relu(net).t() @ rb(dx), "bias": dx.sum(0)}
        dnet = (rb(dx) @ w(fc1).t()) * (net > 0)
        grads[fc0] = {"kernel": torch.relu(x_in).t() @ rb(dnet), "bias": dnet.sum(0)}
        dx = dx + (rb(dnet) @ w(fc0).t()) * (x_in > 0)
        if i < n_lin_z:
            dtz.insert(0, dx)
    for i, d in enumerate(dtz):
        grads[f"lin_z_{i}"] = {"bias": d.sum(0)}
    grads["lin_in"] = {"kernel": rb(x2).t() @ rb(dx), "bias": dx.sum(0)}
    dtz_all = (torch.cat(dtz, dim=-1) if dtz
               else torch.zeros((x2.shape[0], 0), device=x2.device))
    return grads, dtz_all.to(tz.dtype).reshape(tz.shape)


def _pack(params, cfg, d_in: int, d_out: int, device):
    """Weights into the kernel's packed layout (see njf_field_mlp_tz_fwd)."""
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


def _fused_resnet_fc_tz_cuda(params, cfg, tz, x, d_out):
    lead = tz.shape[:-1]
    dh = cfg.d_hidden
    n_lin_z = _n_lin_z(cfg)
    d_in = x.shape[-1]
    if tz.shape[-1] != n_lin_z * dh:
        raise ValueError(f"tz width {tz.shape[-1]} != n_lin_z*d_hidden {n_lin_z * dh}")
    if dh not in (32, 64, 128) or not 0 < d_out <= 32 or not 0 < d_in <= 128:
        raise ValueError(f"K7-tz takes d_hidden in (32, 64, 128), d_out <= 32, "
                         f"d_in <= 128; got {dh}, {d_out}, {d_in}")
    x2 = x.reshape(-1, d_in).to(_BF).contiguous()
    n = x2.shape[0]
    if tz.numel() != n * tz.shape[-1]:
        raise ValueError(f"point counts differ: tz {tuple(tz.shape)}, x {tuple(x.shape)}")
    tz2 = tz.reshape(n, tz.shape[-1]).to(_BF).contiguous()
    check_cuda_tensor(tz2, "K7-tz tz", _BF, 2)
    check_cuda_tensor(x2, "K7-tz x", _BF, 2)
    wbuf, bbuf = _pack(params, cfg, d_in, d_out, x2.device)
    out = torch.empty((n, d_out), dtype=torch.float32, device=x2.device)
    if n == 0:
        return out.reshape(*lead, d_out)
    lib = load_kernels()
    with torch.cuda.device(x2.device):
        fused_resnet_fc_tz.launches += 1
        lib.call("njf_field_mlp_tz_fwd", tz2.data_ptr(), x2.data_ptr(),
                 wbuf.data_ptr(), bbuf.data_ptr(), out.data_ptr(), n, d_in, dh,
                 cfg.n_blocks, n_lin_z, d_out, stream_of(x2))
    return out.reshape(*lead, d_out)


def fused_resnet_fc_tz(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                       d_out: int) -> torch.Tensor:
    """K7-tz-fwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc_tz", x,
                    lambda: _fused_resnet_fc_tz_cuda(params, cfg, tz, x, d_out),
                    lambda: fused_resnet_fc_tz_plain(params, cfg, tz, x, d_out))


def _unpack_grads(flat, params, cfg, d_in: int, d_out: int):
    """The kernel's float32 dW ++ db (the packed layouts of _pack) -> the
    params' layout."""
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


def _fused_resnet_fc_tz_bwd_cuda(params, cfg, tz, x, g, d_out):
    dh, nb = cfg.d_hidden, cfg.n_blocks
    n_lin_z = _n_lin_z(cfg)
    d_in = x.shape[-1]
    if tz.shape[-1] != n_lin_z * dh:
        raise ValueError(f"tz width {tz.shape[-1]} != n_lin_z*d_hidden {n_lin_z * dh}")
    if dh not in (32, 64, 128) or not 0 < d_out <= 32 or not 0 < d_in <= 128:
        raise ValueError(f"K7-tz takes d_hidden in (32, 64, 128), d_out <= 32, "
                         f"d_in <= 128; got {dh}, {d_out}, {d_in}")
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
    dtz = torch.empty((n, n_lin_z * dh), dtype=_BF, device=dev)
    if n == 0:
        zeros = {k: {leaf: torch.zeros_like(v, dtype=torch.float32) for leaf, v in p.items()}
                 for k, p in params.items()}
        return zeros, dtz.to(tz.dtype).reshape(tz.shape)
    wbuf, bbuf = _pack(params, cfg, d_in, d_out, dev)
    k_in, n_out = (d_in + 15) // 16 * 16, (d_out + 15) // 16 * 16
    w_total = k_in * dh + 2 * nb * dh * dh + dh * n_out
    b_total = dh * (1 + n_lin_z + 2 * nb) + n_out
    n_tiles = -(-n // 64)
    grid = min(n_tiles, 2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    stash = torch.empty((n_tiles * 64, max(nb, 1), dh), dtype=_BF, device=dev)
    wpart = torch.zeros((grid, w_total), dtype=torch.float32, device=dev)
    bpart = torch.zeros((grid * 4, b_total), dtype=torch.float32, device=dev)
    flat = torch.empty(w_total + b_total, dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        fused_resnet_fc_tz_bwd.launches += 1
        lib.call("njf_field_mlp_tz_bwd", tz2.data_ptr(), x2.data_ptr(), g2.data_ptr(),
                 wbuf.data_ptr(), bbuf.data_ptr(), stash.data_ptr(), dtz.data_ptr(),
                 wpart.data_ptr(), bpart.data_ptr(), flat.data_ptr(), n, d_in, dh, nb,
                 n_lin_z, d_out, grid, stream_of(x2))
    return (_unpack_grads(flat, params, cfg, d_in, d_out),
            dtz.to(tz.dtype).reshape(tz.shape))


def fused_resnet_fc_tz_bwd(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, d_out: int):
    """K7-tz-bwd wrapper (same signature as the plain version)."""
    return dispatch("fused_resnet_fc_tz_bwd", x,
                    lambda: _fused_resnet_fc_tz_bwd_cuda(params, cfg, tz, x, g, d_out),
                    lambda: fused_resnet_fc_tz_bwd_plain(params, cfg, tz, x, g, d_out))


fused_resnet_fc_tz.launches = 0
fused_resnet_fc_tz_bwd.launches = 0


def _leaf_names(cfg):
    """(layer, leaf) of every trunk parameter in tz mode, in a fixed order."""
    names = [("lin_in", "kernel"), ("lin_in", "bias")]
    names += [(f"lin_z_{i}", "bias") for i in range(_n_lin_z(cfg))]
    for i in range(cfg.n_blocks):
        for layer in (f"blocks_{i}_fc_0", f"blocks_{i}_fc_1"):
            names += [(layer, "kernel"), (layer, "bias")]
    return names + [("lin_out", "kernel"), ("lin_out", "bias")]


def _as_params(names, leaves):
    params = {}
    for (layer, leaf), t in zip(names, leaves):
        params.setdefault(layer, {})[leaf] = t
    return params


class FusedTrunkTz(torch.autograd.Function):
    """The differentiable trunk (the JAX fused_resnet_fc_train_tz). The
    weights come in as separate tensor arguments so autograd sees them."""

    @staticmethod
    def forward(ctx, cfg, d_out, tz, x, *leaves):
        ctx.cfg, ctx.d_out = cfg, d_out
        ctx.save_for_backward(tz, x, *leaves)
        return fused_resnet_fc_tz(_as_params(_leaf_names(cfg), leaves), cfg, tz, x, d_out)

    @staticmethod
    def backward(ctx, g):
        tz, x, *leaves = ctx.saved_tensors
        names = _leaf_names(ctx.cfg)
        grads, dtz = fused_resnet_fc_tz_bwd(_as_params(names, leaves), ctx.cfg, tz, x, g,
                                            ctx.d_out)
        dleaves = [grads[layer][leaf].to(t.dtype) for (layer, leaf), t in zip(names, leaves)]
        return (None, None, dtz, None, *dleaves)


def fused_resnet_fc_train_tz(params, cfg, tz: torch.Tensor, x: torch.Tensor,
                             d_out: int) -> torch.Tensor:
    """Differentiable trunk: K7-tz-fwd forward, K7-tz-bwd backward (params
    as for fused_resnet_fc_tz; gradients reach every leaf and tz, never x)."""
    leaves = [params[layer][leaf] for layer, leaf in _leaf_names(cfg)]
    return FusedTrunkTz.apply(cfg, d_out, tz, x, *leaves)
