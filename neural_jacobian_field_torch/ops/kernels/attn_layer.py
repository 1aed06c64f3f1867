"""JT-fwd / JT-bwd: one pre-norm cross-attention layer of the Jacobian
transformer, forward and backward — the CUDA kernels and their plain
versions.

No Pallas site: the JAX module (neural_jacobian_field_tpu/models/
transformer.py) is left to XLA. The port's per-op module
(models/transformer.py) runs a layer as ~25 PyTorch kernels whose [N, 512]
q, scores, softmax and attention output, and their gradients, pass through
device memory; these kernels keep them on chip (csrc/attn_layer.cu says
how). The layer, for x [n, 64] float32 and K, V [A, 512] (A <= 8 keys, 8
heads of 64), with the per-op module's rounding points:

    a1 = bf16(LN1(x));  q = bf16(a1 W_q^T);  s = bf16(bf16(q_h K_h^T) * scale)
    p = bf16(softmax_f32(s));  o = bf16(p_h V_h);  x1 = x + bf16(o W_out^T + b_out)
    a2 = bf16(LN2(x1));  g = bf16(gelu(bf16(a2 W1^T + b1)));  y = x1 + bf16(g W2^T + b2)

The backward keeps float32 where autograd rounds a gradient to bf16 (dP,
dx1, da1, da2), rounds where a gradient is a matmul operand (as autograd
does), and sums the weight gradients as products of reductions over the
points: M = a1^T dscore and R = p^T bf16(dx1) give dW_q, dK, dW_out and dV
without the [N, 512] dq and o (`_param_grads`). The plain versions repeat
that arithmetic in float32 on bf16-valued operands. On the card the
training forward (`save`) also keeps x1 and each head's p and scores for
JT-bwd, which so recomputes no attention; the serving forward keeps
nothing.

Dispatch is by device: a CUDA tensor launches the kernels (or raises), a
CPU tensor takes the plain version. `attn_layer` is the differentiable
entry point; models/transformer.py takes it where `supported` holds.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of
from .conv_suite import SMS, _on_device

WIDTH, HEADS, DIM_HEAD = 64, 8, 64
MAX_KEYS, MAX_HIDDEN = 8, 64
KEY_ROWS = 16          # packed rows a head of K and V: the products run over 16 keys
ROWS = 1408            # packed weight rows (csrc/attn_layer.cu)
W_TOTAL = 16384        # M [64, 64], R [64, 64], fc1 [64, 64], fc2 [64, 64]
BIAS_FLOATS = 7 * 64   # b_out, b1, b2, LN1 scale, bias, LN2 scale, bias
# bf16 slots of 64 columns a point: what the training forward saves (p and
# the scores, 8 heads x 8 keys each) and the backward's scratch (the weight
# gradients' operands)
SAVED_SLOTS, SCRATCH_SLOTS = 2, 7
PTS = 64               # points a warpgroup tile
FWD_WGS, BWD_WGS = 4, 4  # warpgroups a block: JT-fwd, the gradient chain
EPS = 1e-6


class LayerWeights(NamedTuple):
    """One layer's parameters, as the module holds them (float32)."""
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wq: torch.Tensor       # to_q.weight [512, 64]
    wout: torch.Tensor     # to_out.weight [64, 512]
    bout: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor       # fc1.weight [hidden, 64]
    b1: torch.Tensor
    w2: torch.Tensor       # fc2.weight [64, hidden]
    b2: torch.Tensor


def supported(dim: int, heads: int, dim_head: int, hidden: int, keys: int) -> bool:
    """Whether the kernels' instantiation takes a layer of these widths."""
    return (dim == WIDTH and heads == HEADS and dim_head == DIM_HEAD and 1 <= hidden <= MAX_HIDDEN
            and 1 <= keys <= MAX_KEYS)


def _rounding(dtype):
    """float32 values rounded to `dtype` (bf16) or, for float32, as they are."""
    if dtype == torch.float32:
        return lambda t: t.float()
    return lambda t: t.to(dtype).float()


def pack_weights(k: torch.Tensor, v: torch.Tensor, p: LayerWeights) -> torch.Tensor:
    """bf16 [1408, 64]: W_q, W_out's 8 column blocks, fc1 (hidden rows
    padded to 64), fc2 (hidden columns padded), K and V per head padded to
    16 rows."""
    a, hidden = k.shape[0], p.w1.shape[0]
    bf = torch.bfloat16

    def per_head(t):  # [A, 512] -> [8 x 16, 64]
        t = t.to(bf).reshape(a, HEADS, DIM_HEAD).transpose(0, 1)
        return F.pad(t, (0, 0, 0, KEY_ROWS - a)).reshape(HEADS * KEY_ROWS, DIM_HEAD)

    wout = p.wout.to(bf).reshape(WIDTH, HEADS, DIM_HEAD).transpose(0, 1).reshape(-1, DIM_HEAD)
    return torch.cat([p.wq.to(bf), wout,
                      F.pad(p.w1.to(bf), (0, 0, 0, MAX_HIDDEN - hidden)),
                      F.pad(p.w2.to(bf), (0, MAX_HIDDEN - hidden)),
                      per_head(k), per_head(v)]).contiguous()


def pack_biases(p: LayerWeights) -> torch.Tensor:
    """float32 [448]: b_out, b1 (padded to 64), b2 rounded to bf16, then
    the two LayerNorms' scale and bias."""
    hidden, bf = p.w1.shape[0], _rounding(torch.bfloat16)
    return torch.cat([bf(p.bout), F.pad(bf(p.b1), (0, MAX_HIDDEN - hidden)), bf(p.b2),
                      p.ln1_w.float(), p.ln1_b.float(), p.ln2_w.float(),
                      p.ln2_b.float()]).contiguous()


# ---------------------------------------------------------------- plain


class _Stats(NamedTuple):
    mean: torch.Tensor
    rstd: torch.Tensor
    clamped: torch.Tensor


def _stats(x: torch.Tensor) -> _Stats:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mean * mean
    return _Stats(mean, torch.rsqrt(torch.clamp(var, min=0.0) + EPS), var < 0)


def _ln(x, st: _Stats, w, b):
    return (x - st.mean) * (st.rstd * w) + b


def _ln_bwd(da, x, st: _Stats, w):
    """The LayerNorm's input gradient: rstd (g - mean(g) - xhat mean(g xhat)),
    g = da w, the last term dropped where the variance's clamp held."""
    g = da * w
    xhat = (x - st.mean) * st.rstd
    m2 = torch.where(st.clamped, 0.0, (g * xhat).mean(dim=-1, keepdim=True))
    return st.rstd * (g - g.mean(dim=-1, keepdim=True) - xhat * m2)


def _gelu_grad(x):
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return cdf + x * (0.3989422804014327 * torch.exp(x * x * -0.5))


def _forward_plain(x, k, v, p: LayerWeights, scale: float, dtype) -> dict:
    """The forward of every point, with what the backward reads; `dtype` the
    compute dtype whose roundings it repeats (bf16, the kernels'; float32
    rounds nothing)."""
    rd = _rounding(dtype)
    n, a = x.shape[0], k.shape[0]
    kh, vh = rd(k).reshape(a, HEADS, DIM_HEAD), rd(v).reshape(a, HEADS, DIM_HEAD)
    st1 = _stats(x)
    a1 = rd(_ln(x, st1, p.ln1_w, p.ln1_b))
    q = rd(a1 @ rd(p.wq).T).reshape(n, HEADS, DIM_HEAD)
    s = rd(rd(torch.einsum("nhd,ahd->nha", q, kh)) * scale)
    pf = torch.softmax(s, dim=-1)
    pb = rd(pf)
    o = rd(torch.einsum("nha,ahd->nhd", pb, vh)).reshape(n, HEADS * DIM_HEAD)
    x1 = x + rd(o @ rd(p.wout).T + rd(p.bout))
    st2 = _stats(x1)
    a2 = rd(_ln(x1, st2, p.ln2_w, p.ln2_b))
    hid = rd(a2 @ rd(p.w1).T + rd(p.b1))
    g = rd(F.gelu(hid))
    y = x1 + rd(g @ rd(p.w2).T + rd(p.b2))
    return dict(y=y, kh=kh, vh=vh, st1=st1, a1=a1, pf=pf, pb=pb, x1=x1, st2=st2, a2=a2,
                hid=hid, g=g)


def attn_layer_fwd_plain(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: LayerWeights,
                         scale: float, packed=None, save: bool = False, *,
                         dtype=torch.bfloat16):
    """x [n, 64] float32, K, V [A, 512] -> y [n, 64] float32, rounded where
    a `dtype` (bf16, the kernel's) module rounds; with `save`, (y, None):
    the plain backward saves nothing. `packed` (the wrapper's packing) is
    not read."""
    y = _forward_plain(x.float(), k, v, p, scale, dtype)["y"]
    return (y, None) if save else y


def _param_grads(m, r, w1t, w2t, sums, k, v, p: LayerWeights, dtype=torch.bfloat16) -> tuple:
    """The parameter gradients (float32, each in its parameter's shape, K
    and V [A, 512]) from the reductions over the points: M [64, 8, A] =
    a1^T dscore, R [8, A, 64] = p^T bf16(dx1), a2^T dh [64, hidden], g^T dy
    [hidden, 64] and the column sums [7, 64]."""
    rd = _rounding(dtype)
    a, hidden = k.shape[0], p.w1.shape[0]
    kh, vh = rd(k).reshape(a, HEADS, DIM_HEAD), rd(v).reshape(a, HEADS, DIM_HEAD)
    wq = rd(p.wq).reshape(HEADS, DIM_HEAD, WIDTH)
    wout = rd(p.wout).reshape(WIDTH, HEADS, DIM_HEAD)
    dwq = torch.einsum("iha,ahd->hdi", m, kh).reshape(HEADS * DIM_HEAD, WIDTH)
    dk = torch.einsum("iha,hdi->ahd", m, wq).reshape(a, HEADS * DIM_HEAD)
    dwout = torch.einsum("hao,ahd->ohd", r, vh).reshape(WIDTH, HEADS * DIM_HEAD)
    dv = torch.einsum("hao,ohd->ahd", r, wout).reshape(a, HEADS * DIM_HEAD)
    dbout, db1, db2, dln1_w, dln1_b, dln2_w, dln2_b = sums
    return (dk, dv, LayerWeights(dln1_w, dln1_b, dwq, dwout, dbout, dln2_w, dln2_b,
                                 w1t.T.contiguous(), db1[:hidden], w2t.T.contiguous(), db2))


def attn_layer_bwd_plain(x: torch.Tensor, dy: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         p: LayerWeights, scale: float, saved=None, packed=None, *,
                         dtype=torch.bfloat16) -> tuple:
    """The layer's backward: (dx [n, 64], dK [A, 512], dV [A, 512], the
    parameters' gradients as a LayerWeights), all float32, the operands
    rounded where the kernel (`dtype` bf16) rounds them."""
    rd = _rounding(dtype)
    x, dy = x.float(), dy.float()
    n, a = x.shape[0], k.shape[0]
    f = _forward_plain(x, k, v, p, scale, dtype)
    dfb = rd(dy)
    dh = (dfb @ rd(p.w2)) * _gelu_grad(f["hid"])
    dhb = rd(dh)
    da2 = dhb @ rd(p.w1)
    dx1 = dy + _ln_bwd(da2, f["x1"], f["st2"], p.ln2_w)
    dattb = rd(dx1)
    do = rd(dattb @ rd(p.wout)).reshape(n, HEADS, DIM_HEAD)
    dp = torch.einsum("nhd,ahd->nha", do, f["vh"])
    pf = f["pf"]
    ds = rd(pf * (dp - (pf * dp).sum(dim=-1, keepdim=True)) * scale)
    dq = rd(torch.einsum("nha,ahd->nhd", ds, f["kh"])).reshape(n, HEADS * DIM_HEAD)
    da1 = dq @ rd(p.wq)
    dx = dx1 + _ln_bwd(da1, x, f["st1"], p.ln1_w)
    xhat1 = (x - f["st1"].mean) * f["st1"].rstd
    xhat2 = (f["x1"] - f["st2"].mean) * f["st2"].rstd
    m = (f["a1"].T @ ds.reshape(n, HEADS * a)).reshape(WIDTH, HEADS, a)
    r = (f["pb"].reshape(n, HEADS * a).T @ dattb).reshape(HEADS, a, WIDTH)
    sums = (dx1.sum(0), dh.sum(0), dy.sum(0), (da1 * xhat1).sum(0), da1.sum(0),
            (da2 * xhat2).sum(0), da2.sum(0))
    dk, dv, dp_ = _param_grads(m, r, f["a2"].T @ dhb, f["g"].T @ dfb, sums, k, v, p, dtype)
    return dx, dk, dv, dp_


# ----------------------------------------------------------------- CUDA


def _grid(n: int, wgs: int) -> int:
    """Blocks (one an SM) for n points in tiles of 64, `wgs` tiles at a time."""
    return max(1, min(SMS, (n + wgs * PTS - 1) // (wgs * PTS)))


def _check(x, k, v, p, name):
    if x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"{name}: expected x [n, {WIDTH}], got {tuple(x.shape)}")
    if k.shape != v.shape or k.dim() != 2 or k.shape[1] != HEADS * DIM_HEAD:
        raise ValueError(f"{name}: expected K, V [A, {HEADS * DIM_HEAD}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not supported(x.shape[1], HEADS, DIM_HEAD, p.w1.shape[0], k.shape[0]):
        raise ValueError(f"{name}: {k.shape[0]} keys, hidden {p.w1.shape[0]}: outside the "
                         f"kernels' instantiation")


def _packed(k, v, p, packed):
    return packed if packed is not None else (pack_weights(k, v, p), pack_biases(p))


def _n_pad(n: int) -> int:
    return (n + PTS - 1) // PTS * PTS


def _fwd_cuda(x, k, v, p, scale, packed, save):
    _check(x, k, v, p, "attn_layer_fwd")
    x = x.contiguous()
    check_cuda_tensor(x, "attn_layer_fwd x", torch.float32, 2)
    w, b = _packed(k, v, p, packed)
    check_cuda_tensor(w, "attn_layer_fwd weights", torch.bfloat16, 2)
    check_cuda_tensor(b, "attn_layer_fwd biases", torch.float32, 1)
    n, a = x.shape[0], k.shape[0]
    y = torch.empty_like(x)
    saved = None
    if save:
        saved = (torch.empty_like(x),
                 torch.empty((SAVED_SLOTS, _n_pad(n), 64), dtype=torch.bfloat16, device=x.device))
    if n > 0:
        lib = load_kernels()
        with _on_device(x):
            attn_layer_fwd.launches += 1
            lib.call("njf_jt_fwd", x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     saved[0].data_ptr() if save else None,
                     saved[1].data_ptr() if save else None, n, a, float(scale),
                     _grid(n, FWD_WGS), stream_of(x))
    return (y, saved) if save else y


def _bwd_cuda(x, dy, k, v, p, scale, saved, packed):
    _check(x, k, v, p, "attn_layer_bwd")
    x, dy = x.contiguous(), dy.contiguous()
    check_cuda_tensor(x, "attn_layer_bwd x", torch.float32, 2)
    check_cuda_tensor(dy, "attn_layer_bwd dy", torch.float32, 2)
    if dy.shape != x.shape:
        raise ValueError(f"attn_layer_bwd: dy {tuple(dy.shape)} against x {tuple(x.shape)}")
    w, b = _packed(k, v, p, packed)
    n, a, dev = x.shape[0], k.shape[0], x.device
    x1, sv = saved
    check_cuda_tensor(x1, "attn_layer_bwd x1", torch.float32, 2)
    check_cuda_tensor(sv, "attn_layer_bwd saved", torch.bfloat16, 3)
    if x1.shape != x.shape or sv.shape != (SAVED_SLOTS, _n_pad(n), 64):
        raise ValueError(f"attn_layer_bwd: saved {tuple(x1.shape)}, {tuple(sv.shape)} do not "
                         f"match x {tuple(x.shape)} at {a} keys")
    dx = torch.empty_like(x)
    # every float written by the kernels' last pass (zeros with no points)
    out = (torch.empty if n > 0 else torch.zeros)(W_TOTAL + BIAS_FLOATS, dtype=torch.float32,
                                                  device=dev)
    if n > 0:
        grid, splits = _grid(n, BWD_WGS), (SMS + 3) // 4
        scratch = torch.empty((SCRATCH_SLOTS, _n_pad(n), 64), dtype=torch.bfloat16, device=dev)
        wpart = torch.empty((splits, W_TOTAL), dtype=torch.float32, device=dev)
        bpart = torch.empty((grid, BIAS_FLOATS), dtype=torch.float32, device=dev)
        lib = load_kernels()
        with _on_device(x):
            attn_layer_bwd.launches += 1
            lib.call("njf_jt_bwd", x.data_ptr(), x1.data_ptr(), sv.data_ptr(), dy.data_ptr(),
                     w.data_ptr(), b.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
                     wpart.data_ptr(), bpart.data_ptr(), out.data_ptr(), n, a, float(scale),
                     grid, splits, stream_of(x))
    hidden = p.w1.shape[0]
    m = out[:4096].reshape(WIDTH, HEADS, MAX_KEYS)[:, :, :a]
    r = out[4096:8192].reshape(HEADS, MAX_KEYS, WIDTH)[:, :a]
    w1t = out[8192:12288].reshape(WIDTH, MAX_HIDDEN)[:, :hidden]
    w2t = out[12288:W_TOTAL].reshape(MAX_HIDDEN, WIDTH)[:hidden]
    sums = tuple(out[W_TOTAL:].reshape(7, 64))
    dk, dv, dp = _param_grads(m, r, w1t, w2t, sums, k, v, p)
    return dx, dk, dv, dp


def attn_layer_fwd(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: LayerWeights,
                   scale: float, packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   save: bool = False):
    """JT-fwd's wrapper (the plain version's signature; `packed` the
    (pack_weights, pack_biases) of the call, made here where None). With
    `save`, (y, saved): the training forward, whose x1 [n, 64] float32 and
    p and scores (bf16 [2, n_pad, 64]) JT-bwd reads instead of
    recomputing the attention."""
    return dispatch("attn_layer_fwd", x, lambda: _fwd_cuda(x, k, v, p, scale, packed, save),
                    lambda: attn_layer_fwd_plain(x, k, v, p, scale, save=save))


def attn_layer_bwd(x: torch.Tensor, dy: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   p: LayerWeights, scale: float, saved,
                   packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> tuple:
    """JT-bwd's wrapper: the chain, the weight-gradient pass and the ordered
    sums (one launch of the wrapper, three kernels), from what the training
    forward saved (`saved`; the plain version, which saves nothing, reads
    None)."""
    return dispatch("attn_layer_bwd", x, lambda: _bwd_cuda(x, dy, k, v, p, scale, saved, packed),
                    lambda: attn_layer_bwd_plain(x, dy, k, v, p, scale))


attn_layer_fwd.launches = 0
attn_layer_bwd.launches = 0


class _AttnLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, v, scale, train, *params):
        p = LayerWeights(*params)
        packed = (pack_weights(k, v, p), pack_biases(p)) if x.device.type == "cuda" else None
        ctx.scale, ctx.packed, ctx.fwd_saved = scale, packed, None
        if not train:
            return attn_layer_fwd(x, k, v, p, scale, packed)
        ctx.save_for_backward(x, k, v, *params)
        y, ctx.fwd_saved = attn_layer_fwd(x, k, v, p, scale, packed, save=True)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k, v, *params = ctx.saved_tensors
        dx, dk, dv, dp = attn_layer_bwd(x, dy, k, v, LayerWeights(*params), ctx.scale,
                                        ctx.fwd_saved, ctx.packed)
        return (dx, dk.to(k.dtype), dv.to(v.dtype), None, None,
                *(g.to(w.dtype) for g, w in zip(dp, params)))


def attn_layer(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: LayerWeights,
               scale: float) -> torch.Tensor:
    """The differentiable layer: x [..., 64] float32, K, V [A, 512] -> y like
    x; gradients for x, K, V and every parameter."""
    shape = x.shape
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (x, k, v, *p))
    y = _AttnLayer.apply(x.reshape(-1, WIDTH), k, v, scale, train, *p)
    return y.reshape(shape)
