#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # every check below
    python3 chip_smoke.py --profile [MODE]  # only: where a train step's device
                                            # time goes (MODE epipolar, exact,
                                            # fused or action)

Drives the port's main paths (neural_jacobian_field_torch, never JAX) at the
flagship configuration with seeded random weights, in both pixel-feature
modes: "epipolar" (per-ray knot textures, the K7-tz trunks) and "exact" (the
reference-numerics per-sample pyramid gathers: K1 on the coarse level, the
K7 trunks that project the latent themselves):

  1. card and build: the card's name and power limit, the kernels built from
     csrc/ with nvcc, and where the toolkit has cuobjdump the HGMMA /
     UTMALDG / HMMA counts of the K9 and K7 kernels' SASS (every TMA
     kernel, both K7 forward wgmma kernels, both gradient chains and the
     weight-gradient pass of the K7 backward must hold wgmma and TMA loads
     and no legacy mma) (TF32 off for every float32 reference);
  2. each hand-written kernel against its plain PyTorch version at the
     shapes the main paths give it, with error, tolerance, median CUDA-event
     times of both, the least time the card could take (bound: the larger
     of the bytes over 3.35 TB/s and the bf16 operations over 989 TFLOP/s)
     and, where one PyTorch call computes the same function, that call's
     time: the forward kernels (K9-fwd, K6-fwd, K5, K7-tz-fwd, K7-fwd,
     K1-fwd) at the serving shapes (K1-fwd at the train step's; K9-fwd also
     at batch 7, on a line of its own), K10 (the conv with BatchNorm
     statistics) at the 24 convs of a batch-7 encode, its y bit for bit
     K9-fwd's, its yardstick F.conv2d followed by the two reductions; the
     backward kernels (K9-dgrad, K9-wgrad, K6-bwd, K7-tz-bwd and K7-bwd at
     d_out 1, 16 and 24, K1-bwd) at the train step's, K1-bwd also onto a
     45x80 map (a 720x1280 image's layer3, on a line of its own); K10, K5,
     K1-bwd, K7-tz-bwd and K7-bwd twice, for identical bits (K7-tz-fwd and
     K7-fwd too). The
     K7 backward rows print each pass's device time (the gradient chain,
     the weight-gradient pass, the ordered sums) with its TFLOP/s, and the
     chunks and operand scratch of the plan. The conv rows
     take bf16 weights, as the model passes them, and print beside the
     wrapper time the kernels' device time (torch.profiler) and the
     achieved TFLOP/s; so do the K7 forward rows, per trunk and summed,
     with the time per call of 20 calls back to back and the host's time
     to enqueue one (the wrapper's host cost); the other rows print their
     device time (the K7 backward rows with their TFLOP/s; K5 and K1-bwd
     their bound over it and the host's time to enqueue one call);
  3. serving, per mode: a full 480x640 target view rendered in 2048-ray
     chunks from a 480x640 context image (launch counters reset just
     before, read just after), then one chunk again, stage by stage, with
     the plain versions swapped in;
  4. inverse dynamics on 4096 rays, per mode: encode_image, a
     model-realisable target flow, 100 Adam steps, and the least-squares
     solve;
  5. training, per mode: the stage-1 train step at batch 7 x 256 rays with
     480x640 context images (bf16, forward + backward + Adam): launch counts
     of an update step and of a frozen step (counters reset before each),
     non-zero gradients on every encoder, density-head, colour-head and
     proposal parameter, update / frozen step times and the rays/s of one
     5-frozen + 1-update cycle, peak memory, a loss that falls over 20 steps
     on one batch, and one step's parameter gradients with the kernels
     against the plain versions; then the same in epipolar mode with
     conv_impl="pallas_fused" (K10 in place of K9-fwd; lines "train fused");
  6. stage 2 (action), warm-started from that stage-1 model under
     pallas_fused: flow supervision at batch 7 x 256 rays in both modes and
     tracks at 7 x 1472 in epipolar mode (lines "action epipolar|exact",
     "action tracks"): launch counts per step, the Jacobian head's gradients
     with the kernels against the plain versions, a loss that falls from
     its early peak on a fixed batch at lr 1e-4, step times, rays/s and
     peak memory, every parameter outside decoder.jacobian_head bit for bit
     unchanged and the BatchNorm running statistics moved;
  7. timings and peak memory.
Every main path also checks that no K9 wrapper went to its legacy kernel
(C or Cout not a multiple of 8), and no K7 wrapper to its legacy WMMA
kernel (shapes off fwd_plan's or bwd_plan's wgmma kernels). Any failed
phase exits non-zero.
Without a CUDA device, or without the package beside this script, it exits
non-zero and prints no result. The last three lines are the card line, the
kernel table and the device record, the last two each one JSON object; the
numbers of each mode's train phase are on the lines that start with "train",
those of stage 2 on the lines that start with "action".
"""

import argparse
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

H, W = 480, 640
PATCH = 2048
Z_NEAR, Z_FAR = 0.5, 10.0
ID_RAYS = 4096
SEED = 0
TRAIN_B, TRAIN_RAYS = 7, 256
TRAIN_LR, TRAIN_WARMUP = 5e-4, 5
LOSS_STEPS = 20
# stage 2: lr 1e-4 (Adam at 5e-3 diverges on the near-zero Jacobian
# head); tracks per example as bench.py's action-tracks metric
ACTION_LR, TRACKS = 1e-4, 1472
# stride-1 3x3 convs of the encoder per forward: (H, W, C) at a 480x640
# image -> number of convs (layer1 6, layer2 7, layer3 11)
K9_SHAPES = ((120, 160, 64, 6), (60, 80, 128, 7), (30, 40, 256, 11))
# the coarse pyramid level (layer3) at a 480x640 image, and the latent levels
COARSE_HW, LATENT = (30, 40), (128, 128, 256)
# H100 SXM, NVIDIA's data sheet: dense bf16 tensor rate and memory bandwidth
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
MODES = ("epipolar", "exact")
# the K7 backward's passes by kernel name (the wgmma path: the gradient
# chain, the weight-gradient pass, the ordered sums)
K7_BWD_PASSES = {"chain": r"field_mlp_bwd_chain_kernel", "weight gradients": r"field_mlp_dw_kernel",
                 "sums": r"reduce_bwd_kernel"}


# K1-bwd's stages by kernel name: the bucket sort's count, scan and place,
# the piece sums, the ordered merge
K1_BWD_STAGES = {"count": r"bucket_count_kernel", "scan": r"bucket_scan_kernel",
                 "place": r"bucket_place_kernel", "piece sums": r"segment_sum_kernel",
                 "merge": r"merge_parts_kernel"}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def cuda_time_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() over reps runs, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=5, groups=None):
    """Device milliseconds of fn() per call: the sum of the device intervals
    of its kernels (and copies and fills) under torch.profiler, over reps
    calls after one warm-up. Spans the profiler mirrors from host ranges are
    dropped. With `groups` ({label: regex}), also the milliseconds per call
    of the kernels whose names match each: (total, {label: ms})."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that caught no device event is taken again
        with warnings.catch_warnings():  # "clears events at the end of each cycle"
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        dev_events = [e for e in events
                      if e.device_type == DeviceType.CUDA and e.name not in host]
        us = sum(e.time_range.elapsed_us() for e in dev_events)
        if us > 0:
            break
    check(us > 0, "the profiler recorded no device time")
    if groups is None:
        return us / reps / 1e3
    return us / reps / 1e3, {
        label: sum(e.time_range.elapsed_us() for e in dev_events if re.search(rx, e.name))
        / reps / 1e3 for label, rx in groups.items()}


def sass_counts(lib_path) -> dict:
    """{kernel: (HGMMA, UTMALDG, HMMA)} for the K9 kernels and the K7
    kernels in the built library's SASS, or {} where the toolkit has no
    cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if re.search(r"conv3x3|wgrad|field_mlp_(wg|fwd|bwd_chain|dw_k)",
                                         m.group(1)) else None
            if fn:
                counts[fn] = [0, 0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line
            counts[fn][2] += bool(re.search(r"\bHMMA\b", line))
    return {k: tuple(v) for k, v in counts.items()}


def kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled entry-function name (the last
    length-prefixed identifier ending in "kernel"), with its template
    arguments' code when it has them."""
    name, i = mangled, 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        n, start = int(m.group(0)), i + len(m.group(0))
        ident = mangled[start:start + n]
        if ident.endswith("kernel") and re.fullmatch(r"\w+", ident):
            rest, j = mangled[start + n:], 1
            while rest.startswith("I") and rest[j:j + 1] == "L":  # literal template args
                j = rest.index("E", j) + 1
            name = ident + (rest[:j + 1] if rest.startswith("I") else "")
        i = start + n if re.fullmatch(r"[A-Za-z_]\w*", ident) else start
    return name


def check_no_legacy(label):
    """The legacy kernels of the K9 wrappers (C or Cout not a multiple of 8)
    and of the K7 wrappers (shapes off fwd_plan's or bwd_plan's wgmma
    kernels) ran no time since the counters were reset."""
    from neural_jacobian_field_torch.ops import kernels as K

    legacy = K.legacy_launch_counts()
    check(set(legacy) >= {"K9-fwd", "K10", "K9-dgrad", "K9-wgrad", "K7-tz-fwd", "K7-fwd",
                          "K7-tz-bwd", "K7-bwd"},
          f"{label}: legacy counters {sorted(legacy)}")
    check(not any(legacy.values()), f"{label}: legacy kernels launched {legacy}")


def host_ms(fn, calls=20):
    """The host's milliseconds to enqueue one fn() (the wrapper's host cost):
    20 calls back to back on the host clock, from and to an idle card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Row:
    """One kernel's line of the table, summed over the calls it stands for:
    errors, kernel / plain / library times, and the work (bytes moved: each
    input read once, each output written once; bf16 tensor operations) from
    which its bound is computed."""

    def __init__(self):
        self.errs, self.ms, self.plain_ms, self.library_ms = [], 0.0, 0.0, None
        self.bytes, self.flops = 0, 0.0

    def add(self, err, ms, plain_ms, nbytes_, flops=0.0, library_ms=None):
        self.errs.append(float(err))
        self.ms += ms
        self.plain_ms += plain_ms
        self.bytes += nbytes_
        self.flops += flops
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms

    def record(self):
        t_bytes = self.bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = self.flops / PEAK_BF16_FLOPS * 1e3
        return dict(max_abs_err=max(self.errs), ms=self.ms, plain_ms=self.plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="operations" if t_ops > t_bytes else "bytes",
                    library_ms=self.library_ms)


def print_times(name, k_ms, p_ms, lib_ms=None, extra=""):
    lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"  {name} ms kernel {k_ms:.4f}{extra} plain {p_ms:.4f} library {lib}")


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version where the model looks
    it up (the wrappers' own modules; the autograd.Functions look their
    forward and backward wrappers up there too), so a run goes through the
    plain PyTorch versions on the card, forward and backward."""
    import importlib

    from neural_jacobian_field_torch.ops.kernels import KERNELS

    saved = []
    for wrapper, plain, _, _ in KERNELS.values():
        mod = importlib.import_module(wrapper.__module__)
        saved.append((mod, wrapper.__name__, wrapper))
        setattr(mod, wrapper.__name__, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ------------------------------------------------------------------ phase 2

def trunk_params(g, dev, d_out, d_latent=None):
    """Flagship trunk parameters (d_in 63, 5 x 128, combine_layer 3); the
    lin_z layers with their kernels [d_latent, 128] (projection mode) or
    their bias only (tz mode)."""
    import torch

    def lin(din, dout):
        return {"kernel": torch.randn((din, dout), generator=g, device=dev) / math.sqrt(din),
                "bias": 0.1 * torch.randn((dout,), generator=g, device=dev)}

    params = {"lin_in": lin(63, 128)}
    for i in range(3):
        params[f"lin_z_{i}"] = lin(d_latent, 128) if d_latent else {"bias": lin(1, 128)["bias"]}
    for i in range(5):
        params[f"blocks_{i}_fc_0"] = lin(128, 128)
        params[f"blocks_{i}_fc_1"] = lin(128, 128)
    params["lin_out"] = lin(128, d_out)
    return params


def trunk_flops(n, d_out, projection):
    """bf16 operations of one flagship trunk forward over n points (the latent
    projection 512 x 384 included in projection mode)."""
    per_point = 2.0 * (63 * 128 + 10 * 128 * 128 + 128 * d_out)
    if projection:
        per_point += 2.0 * sum(LATENT) * 3 * 128
    return n * per_point


def latent_levels(g, dev, n):
    """The exact path's latent as the trunks get it: fine and mid bf16 from
    the packed-row gathers, coarse float32 from K1-fwd."""
    import torch

    return tuple(torch.randn((n, c), generator=g, device=dev).to(
        torch.float32 if i == 2 else torch.bfloat16) for i, c in enumerate(LATENT))


def k1_inputs(g, dev, b, n):
    """A coarse map [b, 1200, 256] bf16 and corner ids / weights of n points
    per image spread over it."""
    import torch

    from neural_jacobian_field_torch.ops.pixel_gather import _corner_ids

    hc, wc = COARSE_HW
    flat = torch.randn((b, hc * wc, 256), generator=g, device=dev).to(torch.bfloat16)
    cx = torch.rand((b, n), generator=g, device=dev) * (wc - 1)
    cy = torch.rand((b, n), generator=g, device=dev) * (hc - 1)
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    # the reference's op on the same points: grid_sample, align_corners=True
    grid = torch.stack([cx / (wc - 1) * 2 - 1, cy / (hc - 1) * 2 - 1], dim=-1)[:, :, None]
    nchw = flat.reshape(b, hc, wc, 256).permute(0, 3, 1, 2)
    return flat, idx, w4, nchw, grid.to(torch.bfloat16)


def kernel_checks(dev):
    """Each forward kernel against its plain version at main-path shapes.
    Returns the rows of the kernel table (without launch counts)."""
    import torch
    import torch.nn.functional as F

    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.ops.pdf import pdf_queries

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # K9-fwd: the encoder's stride-1 3x3 convs at B=1 (the table's row) and
    # at batch 7 (the pallas train step's), with bf16 weights as Conv.forward
    # passes them; cuDNN gets the same weights, pre-cast
    for b in (1, TRAIN_B):
        row, dev_ms, lib_dev, b2b = Row(), 0.0, 0.0, [0.0, 0.0]
        for hh, ww, c, count in K9_SHAPES:
            x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn((3, 3, c, c), generator=g, device=dev) / math.sqrt(9 * c)).to(
                torch.bfloat16)
            got, want = K.conv3x3_s1(x, w), K.conv3x3_s1_plain(x, w)
            err = (got.float() - want.float()).abs()
            tol_ok = bool((err <= 2.0 ** -7 * want.float().abs() + 1e-3).all())
            rel = float((err / want.float().abs().clamp_min(1e-3)).max())
            print(f"K9-fwd {b}x{hh}x{ww}x{c}->{c}: max_abs_err {float(err.max()):.3e} "
                  f"max_rel_err {rel:.3e} (tol: 2^-7*|ref| + 1e-3 per element) ok={tol_ok}")
            check(tol_ok, "K9-fwd disagrees with its plain version")
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k_ms = cuda_time_ms(lambda: K.conv3x3_s1(x, w))
            p_ms = cuda_time_ms(lambda: K.conv3x3_s1_plain(x, w))
            l_ms = cuda_time_ms(lambda: F.conv2d(xc, wc, padding=1))
            d_ms = device_ms(lambda: K.conv3x3_s1(x, w))
            ld_ms = device_ms(lambda: F.conv2d(xc, wc, padding=1))
            flops = 2.0 * b * hh * ww * 9 * c * c
            print_times("", k_ms, p_ms, l_ms, extra=f" (device {d_ms:.4f}, "
                        f"{flops / d_ms / 1e9:.1f} TFLOP/s; library's device {ld_ms:.4f})")
            if b == 1:  # one call's time is mostly launch latency: also 20 in a row
                k20, l20 = (cuda_time_ms(lambda: [f() for _ in range(20)]) / 20 for f in (
                    lambda: K.conv3x3_s1(x, w), lambda: F.conv2d(xc, wc, padding=1)))
                print(f"   back to back, ms per call: kernel {k20:.4f} cuDNN {l20:.4f}")
                b2b = [b2b[0] + count * k20, b2b[1] + count * l20]
            row.add(err.max(), count * k_ms, count * p_ms, count * nbytes(x, w, got),
                    count * flops, count * l_ms)
            dev_ms += count * d_ms
            lib_dev += count * ld_ms
        rec = row.record()
        print(f"K9-fwd per encode at batch {b} (24 convs): kernel {row.ms:.4f} ms, device "
              f"{dev_ms:.4f} ms ({row.flops / dev_ms / 1e9:.1f} TFLOP/s; cuDNN's device "
              f"{lib_dev:.4f} ms), plain "
              f"{row.plain_ms:.4f} ms, cuDNN {row.library_ms:.4f} ms, kernel/library "
              f"{row.ms / row.library_ms:.3f}, bound {rec['bound_ms']:.4f} ms"
              + (f"; back to back kernel {b2b[0]:.4f} ms, cuDNN {b2b[1]:.4f} ms, kernel/library "
                 f"{b2b[0] / b2b[1]:.3f}" if b == 1 else ""))
        if b == 1:
            rows["K9-fwd"] = rec

    # K6-fwd: fine + mid per encode, coarse per chunk (epipolar)
    row, dev_sum = Row(), 0.0
    for hh, ww, c in ((240, 320, 128), (60, 80, 128), (30, 40, 256)):
        x = torch.randn((1, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
        got, want = K.pack_2x2_flat(x), K.pack_2x2_flat_plain(x)
        err = float((got.float() - want.float()).abs().max())
        print(f"K6-fwd 1x{hh}x{ww}x{c}: max_abs_err {err:.3e} (tol: 0, a copy)")
        check(err == 0.0, "K6-fwd disagrees with its plain version")
        k_ms = cuda_time_ms(lambda: K.pack_2x2_flat(x))
        p_ms = cuda_time_ms(lambda: K.pack_2x2_flat_plain(x))
        d_ms = device_ms(lambda: K.pack_2x2_flat(x))
        dev_sum += d_ms
        print_times("", k_ms, p_ms, extra=f" (device {d_ms:.4f})")
        row.add(err, k_ms, p_ms, nbytes(x, got))
    rows["K6-fwd"] = row.record()
    print(f"K6-fwd fine + mid + coarse: kernel {row.ms:.4f} ms, device {dev_sum:.4f} ms")

    # K5: one 2048-ray chunk, 256 proposal bins -> 256 NeRF samples
    n, s = PATCH, 256
    bins = torch.sort(torch.rand((n, s + 1), generator=g, device=dev), dim=-1).values
    wts = torch.rand((n, s), generator=g, device=dev)
    u = pdf_queries((n,), s, stratified=False, device=dev)
    got, want = K.fused_sample_pdf(bins, wts, u), K.fused_sample_pdf_plain(bins, wts, u)
    err = (got - want).abs()
    frac = float((err > 1e-4).float().mean())
    width = float(torch.diff(bins, dim=-1).max())
    # float32 CDFs summed in different orders differ by ~1e-7 per step; the
    # interpolation divides that by the bin's pdf, so low-weight bins move a
    # sample by up to ~1e-4; a query at a bin tie may change bin
    print(f"K5 [{n},{s + 1}]: max_abs_err {float(err.max()):.3e}; share above 1e-4 "
          f"{frac:.2e} (tol: 1e-4 but for <= 1e-4 of elements at bin ties, each "
          f"within one bin width {width:.3e})")
    check(frac <= 1e-4 and float(err.max()) <= width, "K5 disagrees with its plain version")
    again = K.fused_sample_pdf(bins, wts, u)
    check(bool(torch.equal(got, again)), "K5 does not repeat bit for bit")
    row = Row()
    row.add(err.max(), cuda_time_ms(lambda: K.fused_sample_pdf(bins, wts, u)),
            cuda_time_ms(lambda: K.fused_sample_pdf_plain(bins, wts, u)),
            nbytes(bins, wts, u, got))
    rows["K5"] = row.record()
    d_ms = device_ms(lambda: K.fused_sample_pdf(bins, wts, u))
    host = host_ms(lambda: K.fused_sample_pdf(bins, wts, u))
    print_times("", row.ms, row.plain_ms,
                extra=f" (device {d_ms:.4f}, bound/device {rows['K5']['bound_ms'] / d_ms:.1%}; "
                      f"host enqueue {host:.4f} per call); two calls bit-identical=True")

    # K7-tz-fwd and K7-fwd: the three trunks of one chunk (2048 rays x 256
    # samples); K7-fwd takes the latent levels and projects them itself
    cfg = MlpCfg(n_blocks=5, d_hidden=128, combine_layer=3)
    npts = PATCH * 256
    tz = (torch.randn((npts, 384), generator=g, device=dev)).to(torch.bfloat16)
    x = (torch.rand((npts, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    z = latent_levels(g, dev, npts)
    for name, wrapper, plain, proj in (
            ("K7-tz-fwd", K.fused_resnet_fc_tz, K.fused_resnet_fc_tz_plain, False),
            ("K7-fwd", K.fused_resnet_fc, K.fused_resnet_fc_plain, True)):
        row, dev_sum, b2b_sum, host_sum = Row(), 0.0, 0.0, 0.0
        lat = z if proj else tz
        for d_out in (1, 16, 24):
            params = trunk_params(g, dev, d_out, sum(LATENT) if proj else None)
            got = wrapper(params, cfg, lat, x, d_out)
            again = wrapper(params, cfg, lat, x, d_out)
            want = plain(params, cfg, lat, x, d_out)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            same = bool(torch.equal(got, again))
            print(f"{name} N={npts} d_out={d_out}: max_abs_err {err:.3e} "
                  f"rel_to_scale {err / scale:.3e} (tol: 1e-2 of scale {scale:.3e}); two calls "
                  f"bit-identical={same}")
            check(torch.isfinite(got).all().item() and err <= 1e-2 * scale and same,
                  f"{name} disagrees with its plain version or does not repeat")
            del got, again, want

            def call():
                return wrapper(params, cfg, lat, x, d_out)

            k_ms = cuda_time_ms(call, reps=5)
            p_ms = cuda_time_ms(lambda: plain(params, cfg, lat, x, d_out), reps=5)
            d_ms = device_ms(call)
            # 20 calls back to back: per call on the device's clock, and the
            # host's enqueue time per call (the wrapper's host cost)
            b2b = cuda_time_ms(lambda: [call() for _ in range(20)], reps=3, warmup=1) / 20
            host = host_ms(call)
            flops = trunk_flops(npts, d_out, proj)
            print_times("", k_ms, p_ms, extra=f" (device {d_ms:.4f}, {flops / d_ms / 1e9:.1f} "
                        f"TFLOP/s; 20 back to back {b2b:.4f} per call, host {host:.4f} per "
                        f"call)")
            inputs = z if proj else (tz,)
            row.add(err, k_ms, p_ms, nbytes(*inputs, x) + npts * d_out * 4, flops)
            dev_sum, b2b_sum, host_sum = dev_sum + d_ms, b2b_sum + b2b, host_sum + host
        rows[name] = row.record()
        print(f"{name} three trunks (d_out 1, 16, 24), N={npts}: kernel {row.ms:.4f} ms, device "
              f"{dev_sum:.4f} ms ({row.flops / dev_sum / 1e9:.1f} TFLOP/s), back to back "
              f"{b2b_sum:.4f} ms, host {host_sum:.4f} ms, plain {row.plain_ms:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']})")
    del tz, x, z
    torch.cuda.empty_cache()
    return rows


def k10_checks(dev):
    """K10 against its plain version at the 24 stride-1 convs of a batch-7
    encode (the train step's). Returns its row of the kernel table."""
    import torch
    import torch.nn.functional as F

    from neural_jacobian_field_torch.ops import kernels as K

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    b, row, dev_ms, lib_dev = TRAIN_B, Row(), 0.0, 0.0
    for hh, ww, c, count in K9_SHAPES:
        x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, c, c), generator=g, device=dev) / math.sqrt(9 * c)).to(
            torch.bfloat16)
        y, s1, s2 = K.conv3x3_s1_stats(x, w)
        y2, s1b, s2b = K.conv3x3_s1_stats(x, w)
        same_y = bool(torch.equal(y, K.conv3x3_s1(x, w)))
        repeat = all(torch.equal(a, c_) for a, c_ in ((y, y2), (s1, s1b), (s2, s2b)))
        _, p1, p2 = K.conv3x3_s1_stats_plain(x, w)
        # float32 sums of the same products in another order: s2, a sum of
        # squares, to 1e-4 of itself; s1 to 1e-4 of sqrt(n * s2), which
        # bounds the sum of |y| (Cauchy-Schwarz), since s1 may cancel to ~0
        n = b * hh * ww
        e1 = float(((s1 - p1).abs() / (n * p2).sqrt().clamp_min(1e-30)).max())
        e2 = float(((s2 - p2).abs() / p2.clamp_min(1e-30)).max())
        print(f"K10 {b}x{hh}x{ww}x{c}->{c}: y bit-identical to K9-fwd={same_y}; s1 err "
              f"{e1:.3e} of sqrt(n s2) (tol 1e-4), s2 err {e2:.3e} relative (tol 1e-4); "
              f"two calls bit-identical={repeat}")
        check(same_y and repeat and e1 <= 1e-4 and e2 <= 1e-4,
              "K10 disagrees with K9-fwd or its plain version, or does not repeat")
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def yardstick():  # cuDNN conv, then the two float32 reductions
            yy = F.conv2d(xc, wc, padding=1).float()
            return yy.sum(dim=(0, 2, 3)), (yy * yy).sum(dim=(0, 2, 3))

        k_ms = cuda_time_ms(lambda: K.conv3x3_s1_stats(x, w))
        p_ms = cuda_time_ms(lambda: K.conv3x3_s1_stats_plain(x, w))
        l_ms = cuda_time_ms(yardstick)
        d_ms = device_ms(lambda: K.conv3x3_s1_stats(x, w))
        ld_ms = device_ms(yardstick)
        flops = 2.0 * n * 9 * c * c
        print_times("", k_ms, p_ms, l_ms, extra=f" (device {d_ms:.4f}, "
                    f"{flops / d_ms / 1e9:.1f} TFLOP/s; yardstick's device {ld_ms:.4f})")
        row.add(max(float((s1 - p1).abs().max()), float((s2 - p2).abs().max())),
                count * k_ms, count * p_ms, count * nbytes(x, w, y, s1, s2),
                count * flops, count * l_ms)
        dev_ms += count * d_ms
        lib_dev += count * ld_ms
    rec = row.record()
    print(f"K10 per batch-7 encode (24 convs): kernel {row.ms:.4f} ms, device {dev_ms:.4f} ms "
          f"({row.flops / dev_ms / 1e9:.1f} TFLOP/s; the yardstick's device {lib_dev:.4f} ms), "
          f"plain {row.plain_ms:.4f} ms, yardstick "
          f"F.conv2d + sum + sum of squares {row.library_ms:.4f} ms, kernel/library "
          f"{row.ms / row.library_ms:.3f}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    torch.cuda.empty_cache()
    return {"K10": rec}


def backward_kernel_checks(dev):
    """Each backward kernel (and K1-fwd) against its plain version at the
    train step's shapes (batch 7). Returns its rows of the kernel table; ms
    are per train step (K7-tz-bwd and K7-bwd: the proposal and density
    trunks of a stage-1 update step plus the Jacobian trunk of a stage-2
    step; K1: per call)."""
    import torch
    import torch.nn.grad as nn_grad

    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.ops.kernels import field_mlp
    from neural_jacobian_field_torch.ops.pixel_gather import _corner_ids

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    b = TRAIN_B

    # K9-wgrad and K9-dgrad at the three encoder shapes
    wrow, drow, wdev, ddev, wlib, dlib = Row(), Row(), 0.0, 0.0, 0.0, 0.0
    for hh, ww, c, count in K9_SHAPES:
        x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, c, c), generator=g, device=dev) / math.sqrt(9 * c)).to(
            torch.bfloat16)
        gy = torch.randn((b, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
        # wgrad: the same bf16 products summed in float32 in another order
        got, want = K.conv3x3_s1_wgrad(x, gy), K.conv3x3_s1_wgrad_plain(x, gy)
        werr = rel_err(got, want)
        print(f"K9-wgrad {b}x{hh}x{ww}x{c}: max_abs_err {float((got - want).abs().max()):.3e} "
              f"rel_to_scale {werr:.3e} (tol 1e-4 of scale: float32 sums reordered)")
        check(werr <= 1e-4, "K9-wgrad disagrees with its plain version")
        wgot, wabs = got, float((got - want).abs().max())
        # dgrad alone: one bf16 rounding of a float32 sum on each side
        got, want = K.conv3x3_s1_dgrad(gy, w), K.conv3x3_s1_dgrad_plain(gy, w)
        derr = (got.float() - want.float()).abs()
        ok = bool((derr <= 2.0 ** -7 * want.float().abs() + 1e-3).all())
        # the whole Function: autograd.grad through conv_s1 against plain
        # autograd, which adds the nine taps' bf16 gradients in bf16
        xr, wr = x.clone().requires_grad_(), w.float().requires_grad_()
        dx, dw = torch.autograd.grad(K.conv_s1(xr, wr), (xr, wr), gy)
        px, pw = torch.autograd.grad(K.conv3x3_s1_plain(xr, wr), (xr, wr), gy)
        fx, fw = rel_err(dx, px), rel_err(dw, pw)
        print(f"K9-dgrad {b}x{hh}x{ww}x{c}: max_abs_err {float(derr.max()):.3e} (tol 2^-7|ref|"
              f" + 1e-3 per element) ok={ok}; autograd.grad vs plain autograd: dx "
              f"{fx:.3e} (tol 3e-2 of scale), dW {fw:.3e} (tol 1e-2 of scale)")
        check(ok and fx <= 3e-2 and fw <= 1e-2, "K9 backward disagrees with plain autograd")
        del xr, wr, dx, dw, px, pw
        xc, gyc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        tw = (cuda_time_ms(lambda: K.conv3x3_s1_wgrad(x, gy)),
              cuda_time_ms(lambda: K.conv3x3_s1_wgrad_plain(x, gy)),
              cuda_time_ms(lambda: nn_grad.conv2d_weight(xc, wc.shape, gyc, padding=1)))
        td = (cuda_time_ms(lambda: K.conv3x3_s1_dgrad(gy, w)),
              cuda_time_ms(lambda: K.conv3x3_s1_dgrad_plain(gy, w)),
              cuda_time_ms(lambda: nn_grad.conv2d_input(xc.shape, wc, gyc, padding=1)))
        dw_ms = device_ms(lambda: K.conv3x3_s1_wgrad(x, gy))
        dd_ms = device_ms(lambda: K.conv3x3_s1_dgrad(gy, w))
        lw_ms = device_ms(lambda: nn_grad.conv2d_weight(xc, wc.shape, gyc, padding=1))
        ldd_ms = device_ms(lambda: nn_grad.conv2d_input(xc.shape, wc, gyc, padding=1))
        conv_flops = 2.0 * b * hh * ww * 9 * c * c
        print_times("wgrad", *tw, extra=f" (device {dw_ms:.4f}, "
                    f"{conv_flops / dw_ms / 1e9:.1f} TFLOP/s; library's device {lw_ms:.4f})")
        print_times("dgrad", *td, extra=f" (device {dd_ms:.4f}, "
                    f"{conv_flops / dd_ms / 1e9:.1f} TFLOP/s; library's device {ldd_ms:.4f})")
        wdev += count * dw_ms
        ddev += count * dd_ms
        wlib += count * lw_ms
        dlib += count * ldd_ms
        flops = count * conv_flops
        wrow.add(wabs, count * tw[0],
                 count * tw[1], count * nbytes(x, gy, wgot), flops, count * tw[2])
        drow.add(derr.max(), count * td[0], count * td[1], count * nbytes(gy, w, got), flops,
                 count * td[2])
    rows["K9-wgrad"], rows["K9-dgrad"] = wrow.record(), drow.record()
    for name, r, d, ld in (("wgrad", wrow, wdev, wlib), ("dgrad", drow, ddev, dlib)):
        print(f"K9 backward per train step (24 convs): {name} kernel {r.ms:.4f} ms, device "
              f"{d:.4f} ms ({r.flops / d / 1e9:.1f} TFLOP/s; cuDNN's device {ld:.4f} ms), plain "
              f"{r.plain_ms:.4f}, cuDNN {r.library_ms:.4f} ms, kernel/library "
              f"{r.ms / r.library_ms:.3f}")
    torch.cuda.empty_cache()

    # K6-bwd at the fine, mid and coarse levels of batch 7
    row, dev_sum = Row(), 0.0
    for hh, ww, c in ((240, 320, 128), (60, 80, 128), (30, 40, 256)):
        gp = torch.randn((b, hh * ww, 4 * c), generator=g, device=dev).to(torch.bfloat16)
        got, want = K.pack_2x2_flat_bwd(gp, hh), K.pack_2x2_flat_bwd_plain(gp, hh)
        err = float((got.float() - want.float()).abs().max())
        print(f"K6-bwd {b}x{hh}x{ww}x{c}: max_abs_err {err:.3e} (tol 0: the same bf16 "
              f"additions in the same order)")
        check(err == 0.0, "K6-bwd disagrees with its plain version")
        k_ms = cuda_time_ms(lambda: K.pack_2x2_flat_bwd(gp, hh))
        p_ms = cuda_time_ms(lambda: K.pack_2x2_flat_bwd_plain(gp, hh))
        d_ms = device_ms(lambda: K.pack_2x2_flat_bwd(gp, hh))
        dev_sum += d_ms
        print_times("", k_ms, p_ms, extra=f" (device {d_ms:.4f})")
        row.add(err, k_ms, p_ms, nbytes(gp, got))
    rows["K6-bwd"] = row.record()
    print(f"K6-bwd fine + mid + coarse: kernel {row.ms:.4f} ms, device {dev_sum:.4f} ms")
    del gp
    torch.cuda.empty_cache()

    # K1-fwd and K1-bwd: the coarse level of a train step's stage, 7 images
    # x 256 rays x 256 samples (one call of each per stage)
    n = TRAIN_RAYS * 256
    flat, idx, w4, nchw, grid = k1_inputs(g, dev, b, n)
    got, want = K.onehot_gather_fwd(flat, idx, w4), K.onehot_gather_fwd_plain(flat, idx, w4)
    same, err = bool(torch.equal(got, want)), float((got - want).abs().max())
    print(f"K1-fwd {b}x{n}x256 from a 30x40 map: max_abs_err "
          f"{err:.3e} (tol 0: the same float32 products summed in "
          f"the same corner order) bit-exact={same}")
    check(same, "K1-fwd disagrees with its plain version")
    row = Row()
    row.add(err, cuda_time_ms(lambda: K.onehot_gather_fwd(flat, idx, w4)),
            cuda_time_ms(lambda: K.onehot_gather_fwd_plain(flat, idx, w4)),
            nbytes(flat, idx, w4, got),
            library_ms=cuda_time_ms(lambda: torch.nn.functional.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)))
    rows["K1-fwd"] = row.record()
    print_times("", row.ms, row.plain_ms, row.library_ms,
                extra=f" (device {device_ms(lambda: K.onehot_gather_fwd(flat, idx, w4)):.4f})")
    gy = torch.randn((b, n, 256), generator=g, device=dev).to(torch.bfloat16)
    got = K.onehot_scatter_bwd(gy, idx, w4, flat.shape[1])
    want = K.onehot_scatter_bwd_plain(gy, idx, w4, flat.shape[1])
    again = K.onehot_scatter_bwd(gy, idx, w4, flat.shape[1])
    err, same = rel_err(got, want), bool(torch.equal(got, again))
    print(f"K1-bwd {b}x{n}x256 onto a 30x40 map: max_abs_err "
          f"{float((got - want).abs().max()):.3e} rel_to_scale {err:.3e} (tol 1e-4 of scale: "
          f"float32 sums of ~870 terms per texel reordered); two calls bit-identical={same}")
    check(err <= 1e-4 and same, "K1-bwd disagrees with its plain version or does not repeat")
    gy_nchw = gy.reshape(b, n, 1, 256).permute(0, 3, 1, 2)
    row = Row()
    row.add(float((got - want).abs().max()),
            cuda_time_ms(lambda: K.onehot_scatter_bwd(gy, idx, w4, flat.shape[1])),
            cuda_time_ms(lambda: K.onehot_scatter_bwd_plain(gy, idx, w4, flat.shape[1])),
            nbytes(gy, idx, w4, got),
            library_ms=cuda_time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                gy_nchw, nchw, grid, 0, 1, True, [True, False])))
    rows["K1-bwd"] = row.record()
    d_ms, stages = device_ms(lambda: K.onehot_scatter_bwd(gy, idx, w4, flat.shape[1]),
                             groups=K1_BWD_STAGES)
    print("  K1-bwd stages (device ms per call): " + ", ".join(
        f"{label} {ms:.4f}" for label, ms in stages.items()))
    print_times("", row.ms, row.plain_ms, row.library_ms, extra=f" (device {d_ms:.4f}, "
                f"bound/device {rows['K1-bwd']['bound_ms'] / d_ms:.1%}; host enqueue "
                f"{host_ms(lambda: K.onehot_scatter_bwd(gy, idx, w4, flat.shape[1])):.4f} "
                f"per call)")
    del flat, idx, w4, nchw, grid, got, want, again
    # the same points onto a 720x1280 image's layer3 (45x80 = 3,600 texels)
    hc, wc = 45, 80
    cx = torch.rand((b, n), generator=g, device=dev) * (wc - 1)
    cy = torch.rand((b, n), generator=g, device=dev) * (hc - 1)
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    got = K.onehot_scatter_bwd(gy, idx, w4, hc * wc)
    want = K.onehot_scatter_bwd_plain(gy, idx, w4, hc * wc)
    again = K.onehot_scatter_bwd(gy, idx, w4, hc * wc)
    err, same = rel_err(got, want), bool(torch.equal(got, again))
    print(f"K1-bwd {b}x{n}x256 onto a 45x80 map: max_abs_err "
          f"{float((got - want).abs().max()):.3e} rel_to_scale {err:.3e} (tol 1e-4 of scale); "
          f"two calls bit-identical={same}")
    check(err <= 1e-4 and same, "K1-bwd at 45x80 disagrees with its plain version or does "
          "not repeat")
    k_ms = cuda_time_ms(lambda: K.onehot_scatter_bwd(gy, idx, w4, hc * wc))
    p_ms = cuda_time_ms(lambda: K.onehot_scatter_bwd_plain(gy, idx, w4, hc * wc))
    d_ms = device_ms(lambda: K.onehot_scatter_bwd(gy, idx, w4, hc * wc))
    bound = nbytes(gy, idx, w4, got) / PEAK_BYTES_PER_S * 1e3
    print_times("", k_ms, p_ms, extra=f" (device {d_ms:.4f}, bound {bound:.4f}, bound/device "
                f"{bound / d_ms:.1%})")
    del idx, w4, gy, got, want, again
    torch.cuda.empty_cache()

    # K7-tz-bwd and K7-bwd: the proposal (d_out 1) and density (d_out 16)
    # trunks of a stage-1 step and the Jacobian trunk (d_out 24) of a
    # stage-2 step, N = 7 x 256 rays x 256 samples
    cfg = MlpCfg(n_blocks=5, d_hidden=128, combine_layer=3)
    npts = b * TRAIN_RAYS * 256
    tz = torch.randn((npts, 384), generator=g, device=dev).to(torch.bfloat16)
    x = (torch.rand((npts, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    z = latent_levels(g, dev, npts)
    for name, wrapper, plain, proj in (
            ("K7-tz-bwd", K.fused_resnet_fc_tz_bwd, K.fused_resnet_fc_tz_bwd_plain, False),
            ("K7-bwd", K.fused_resnet_fc_bwd, K.fused_resnet_fc_bwd_plain, True)):
        row, dev_sum = Row(), 0.0
        lat = z if proj else tz
        for d_out in (1, 16, 24):
            params = trunk_params(g, dev, d_out, sum(LATENT) if proj else None)
            gy = torch.randn((npts, d_out), generator=g, device=dev)
            grads, dlat = wrapper(params, cfg, lat, x, gy, d_out)
            pgrads, pdlat = plain(params, cfg, lat, x, gy, d_out)

            def worst(fn, got):  # (value, leaf) of the worst leaf against pgrads
                return max((fn(got[k][leaf], v), f"{k}.{leaf}") for k, p in pgrads.items()
                           for leaf, v in p.items())

            def l2(a, b):
                return float((a - b).norm() / b.norm().clamp_min(1e-30))

            (leaf_max, max_name), (leaf_l2, l2_name) = worst(rel_err, grads), worst(l2, grads)
            dname = "dz (each level)" if proj else "dtz"
            l2_tol = 1e-2
            if proj:
                # the plain version again with the latent as one float32 array:
                # the projection's float32 sum in another, equally valid order,
                # which flips some bf16 roundings of the injection; the kernel
                # may be at most twice as far from the plain version as that
                ref_l2, ref_name = worst(l2, plain(params, cfg, torch.cat(
                    [t.float() for t in z], dim=-1), x, gy, d_out)[0])
                l2_tol = max(1e-2, 2 * ref_l2)
                print(f"  {name} reference: plain vs plain with the latent concatenated, worst "
                      f"leaf {ref_name} {ref_l2:.3e} in l2")
            dl2, dfar = 0.0, 0.0
            for a, ref in zip(dlat if proj else (dlat,), pdlat if proj else (pdlat,)):
                derr = (a.float() - ref.float()).abs()
                dl2 = max(dl2, float(derr.norm() / ref.float().norm()))
                dfar = max(dfar, float((derr > 2e-2 * ref.float().abs().max()).float().mean()))
            err = max(float((grads[k][leaf] - v).abs().max()) for k, p in pgrads.items()
                      for leaf, v in p.items())
            print(f"{name} N={npts} d_out={d_out}: dW/db max_abs_err {err:.3e}, worst leaf "
                  f"{max_name} {leaf_max:.3e} of scale (tol 2e-2), {l2_name} {leaf_l2:.3e} in "
                  f"l2 (tol {l2_tol:.3e}); {dname} {dl2:.3e} in l2 (tol 1e-2), share beyond "
                  f"2e-2 of scale {dfar:.2e} (tol 1e-3): bf16 recompute roundings may flip a "
                  f"ReLU mask")
            check(leaf_max <= 2e-2 and leaf_l2 <= l2_tol and dl2 <= 1e-2 and dfar <= 1e-3,
                  f"{name} disagrees with its plain version")
            again, dagain = wrapper(params, cfg, lat, x, gy, d_out)
            same = (all(torch.equal(again[k][leaf], v) for k, p in grads.items()
                        for leaf, v in p.items())
                    and all(torch.equal(a, c) for a, c in zip(dlat if proj else (dlat,),
                                                              dagain if proj else (dagain,))))
            print(f"  {name} two calls bit-identical (every leaf and {dname})={same}")
            check(same, f"{name} does not repeat bit for bit")
            del again, dagain, grads, dlat, pgrads, pdlat
            k_ms = cuda_time_ms(lambda: wrapper(params, cfg, lat, x, gy, d_out), reps=3,
                                warmup=1)
            p_ms = cuda_time_ms(lambda: plain(params, cfg, lat, x, gy, d_out), reps=3, warmup=1)
            d_ms, parts = device_ms(lambda: wrapper(params, cfg, lat, x, gy, d_out), reps=3,
                                    groups=K7_BWD_PASSES)
            dev_sum += d_ms
            # forward recompute + input gradients (the chain) + weight gradients
            flops = 3 * trunk_flops(npts, d_out, proj)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = field_mlp.bwd_plan(npts, 63, 128, 5, 3, d_out, LATENT if proj else None,
                                      sms=sms)
            print_times("", k_ms, p_ms, extra=f" ({flops / k_ms / 1e9:.1f} TFLOP/s; device "
                        f"{d_ms:.4f}, {flops / d_ms / 1e9:.1f} TFLOP/s)")
            rate = {"chain": 2 * flops / 3, "weight gradients": flops / 3}
            print(f"  {name} passes (device ms per call): " + ", ".join(
                f"{k} {v:.4f}" + (f" ({rate[k] / v / 1e9:.1f} TFLOP/s)" if k in rate and v else "")
                for k, v in parts.items()) + f"; {len(plan.chunks(npts))} chunks of <= "
                f"{plan.chunk} points, operand scratch {plan.scratch_bytes / 2**20:.1f} MiB, "
                f"{len(plan.jobs)} weight-gradient jobs x {plan.splits} splits")
            inputs = z if proj else (tz,)
            row.add(err, k_ms, p_ms, 2 * nbytes(*inputs) + nbytes(x, gy), flops)
        rows[name] = row.record()
        print(f"{name} three trunks (d_out 1, 16, 24), N={npts}: kernel {row.ms:.4f} ms, device "
              f"{dev_sum:.4f} ms ({row.flops / dev_sum / 1e9:.1f} TFLOP/s)")
    del tz, x, z
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 3+

def build_model(dev, mode):
    import numpy as np
    import torch

    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg

    g = torch.Generator().manual_seed(SEED)
    model = Model(flagship_model_cfg(pixel_feature_mode=mode),
                  compute_dtype=torch.bfloat16).init_weights(g)
    # a fresh Jacobian head is N(0, 1e-4) everywhere, so every point's
    # Jacobian is the same ~1e-4 constant; draw it at the density head's
    # scale instead and shrink its output layer so that J(x) varies over the
    # scene at ~0.1 m per unit action
    head = model.decoder.jacobian_head
    head.near_zero_init = False
    head.init_weights(g)
    with torch.no_grad():
        head.lin_out.weight.mul_(0.01)
    # BatchNorm running statistics of a trained encoder, not the identity
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return model.to(dev).eval()


def cameras(dev):
    import numpy as np
    import torch

    from neural_jacobian_field_torch.models.model import CameraInput, RobotInput

    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.uniform(size=(1, H, W, 3)).astype(np.float32))
    intr = torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.6, 0.5], [0.0, 0.0, 1.0]]])
    # target camera: 10 degrees about the y axis through a focus point 2 m in
    # front of the context camera, so every epipolar segment has length
    t = math.radians(10.0)
    rot = torch.tensor([[math.cos(t), 0.0, math.sin(t)], [0.0, 1.0, 0.0],
                        [-math.sin(t), 0.0, math.cos(t)]])
    focus = torch.tensor([0.0, 0.0, 2.0])
    trgt = torch.eye(4)
    trgt[:3, :3] = rot
    trgt[:3, 3] = focus - rot @ focus
    action = torch.from_numpy(0.1 * rng.normal(size=(1, 8)).astype(np.float32))
    cam = CameraInput(input_image=image.to(dev), ctxt_extrinsics=torch.eye(4)[None].to(dev),
                      ctxt_intrinsics=intr.to(dev), trgt_extrinsics=trgt[None].to(dev),
                      trgt_intrinsics=intr.to(dev))
    return cam, RobotInput(robot_action=action.to(dev))


def all_zero_but(counts: dict) -> dict:
    """Expected launch counts: the given ones, every other kernel 0."""
    from neural_jacobian_field_torch.ops.kernels import KERNELS

    return {name: counts.get(name, 0) for name in KERNELS}


def chunk_stages(model, cam, robot, ri, given=None):
    """One chunk through the serving path, stage by stage. With `given` (the
    outputs of an earlier run), every stage after the encoder takes that
    run's inputs, so each stage's difference is its own."""
    from neural_jacobian_field_torch.models.pixel_aligned import get_pixel_aligned_features
    from neural_jacobian_field_torch.ops.epipolar import RayKnots
    from neural_jacobian_field_torch.rendering.samplers import pdf_sample, spaced_sample

    out = {}
    pe = model.compute_pixel_encoding(cam, robot)
    out.update(fine2=pe.features.fine2, mid2=pe.features.mid2, coarse=pe.features.coarse)
    if given is not None:
        pe = given["pe"]
    out["pe"] = pe
    rb = model.compute_ray_bundle(ri)
    enc = model.attach_ray_features(pe, rb)
    cfg = model.sampler_cfg
    rs0 = spaced_sample(rb, cfg.num_proposal_samples[0], stratified=False)
    if isinstance(enc.features, RayKnots):
        out["knots"] = enc.features.coarse
    else:  # the coarse level at the proposal samples (K1-fwd)
        pos0 = rs0.get_positions()
        feats, _, _ = get_pixel_aligned_features(pos0.reshape(1, -1, 3), enc.extrinsics,
                                                 enc.intrinsics, enc.features)
        out["coarse samples"] = feats[2]
    if given is not None:
        enc = given["enc"]
    out["enc"] = enc
    out["density0"] = model.proposal_networks[0](rs0.get_positions(), enc)
    d0 = out["density0"] if given is None else given["density0"]
    rs = pdf_sample(rb, rs0, rs0.get_weights(d0), cfg.num_nerf_samples, stratified=False,
                    use_pallas=cfg.use_pallas_pdf)
    out["positions"] = rs.get_positions()
    pos = out["positions"] if given is None else given["positions"]
    dirs = rb.directions[..., None, :].expand(pos.shape)
    dec = model.decoder(pos, dirs, enc)
    out.update(density=dec.density, color=dec.color, action_features=dec.action_features)
    return out


def serve_phase(dev, model, cam, robot, timings, mode):
    import torch

    from neural_jacobian_field_torch.inference.render import camera_rays, render_camera
    from neural_jacobian_field_torch.models.model import RenderingInput
    from neural_jacobian_field_torch.ops import kernels as K

    tag = "" if mode == "epipolar" else "exact_"
    with torch.no_grad():
        # warm-up encode (allocator, cuBLAS handles), then the timed encode
        model.compute_pixel_encoding(cam, robot)
        torch.cuda.synchronize()
        timings[tag + "encode_ms"] = cuda_time_ms(
            lambda: model.compute_pixel_encoding(cam, robot), reps=5, warmup=1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = render_camera(model, cam, robot, Z_NEAR, Z_FAR, H, W, patch_size=PATCH)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = K.launch_counts()
    check_no_legacy(f"{mode} serving")
    timings[tag + "render_s"] = render_s
    timings[tag + "render_rays_per_s"] = H * W / render_s
    timings[tag + "render_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"render {mode} {H}x{W}: {render_s:.3f} s, {H * W / render_s:.1f} rays/s, "
          f"peak {timings[tag + 'render_peak_mem_gib']:.2f} GiB; launches {launches}")

    for name, shape in (("rgb", (1, H, W, 3)), ("depth_raw", (1, H, W, 1)),
                        ("flow_raw", (1, H, W, 2)), ("action_features", (1, H, W, 24))):
        t = getattr(out, name)
        check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
    print(f"rgb range [{float(out.rgb.min()):.4f}, {float(out.rgb.max()):.4f}], depth range "
          f"[{float(out.depth_raw.min()):.4f}, {float(out.depth_raw.max()):.4f}], "
          f"|flow| max {float(out.flow_raw.abs().max()):.4e}")
    n = H * W // PATCH
    if mode == "epipolar":  # K6 packs the coarse level per chunk for the knots
        want = all_zero_but({"K9-fwd": 24, "K6-fwd": 2 + n, "K5": n, "K7-tz-fwd": 3 * n})
    else:
        want = all_zero_but({"K9-fwd": 24, "K6-fwd": 2, "K5": n, "K7-fwd": 3 * n,
                             "K1-fwd": 2 * n})
    check(launches == want, f"{mode} serving launches {launches} != {want}")

    # one chunk again, stage by stage, kernels vs plain versions. A random
    # field at bf16 is chaotic end to end (a 1e-4 m shift of a sample moves
    # its 2^9 NeRF frequency by ~0.3 rad), so each stage gets the SAME inputs
    # in both runs (the kernel run's) and is compared on its own output.
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    lo = (n // 2) * PATCH
    ri = RenderingInput(origins=origins[:, lo:lo + PATCH], directions=dirs[:, lo:lo + PATCH],
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    with torch.no_grad():
        k = chunk_stages(model, cam, robot, ri)
        with plain_kernels():
            p = chunk_stages(model, cam, robot, ri, given=k)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12))

    trunk = "K7-tz" if mode == "epipolar" else "K7"
    feature = (("ray knots", "K6", rel(k["knots"], p["knots"]), 0.0) if mode == "epipolar" else
               ("coarse samples", "K1-fwd", rel(k["coarse samples"], p["coarse samples"]), 0.0))
    checks = [  # (stage, kernels exercised, error, tolerance)
        ("encoder fine2", "K9+K6", rel(k["fine2"], p["fine2"]), 5e-2),
        ("encoder mid2", "K9+K6", rel(k["mid2"], p["mid2"]), 5e-2),
        ("encoder coarse", "K9", rel(k["coarse"], p["coarse"]), 5e-2),
        feature,
        ("proposal density", trunk, rel(k["density0"], p["density0"]), 5e-2),
        ("resampled positions (m)", "K5",
         float((k["positions"] - p["positions"]).abs().max()), 2e-3),
        ("nerf density", trunk, rel(k["density"], p["density"]), 5e-2),
        ("colour", trunk, rel(k["color"], p["color"]), 5e-2),
        ("Jacobian features", trunk, rel(k["action_features"], p["action_features"]), 5e-2),
    ]
    for stage, kern, err, tol in checks:
        print(f"chunk vs plain {mode} [{stage}, {kern}]: err {err:.3e} (tol {tol:g}"
              f"{', relative to scale' if 'positions' not in stage else ''})")
        check(err <= tol, f"{mode} serving stage {stage} disagrees with the plain versions")
    return launches


def inverse_dynamics_phase(dev, model, cam, robot, timings, mode):
    import torch

    from neural_jacobian_field_torch.inference.action_opt import (
        optimize_actions, solve_actions_least_squares)
    from neural_jacobian_field_torch.inference.render import camera_rays
    from neural_jacobian_field_torch.models.model import RenderingInput, RobotInput

    tag = "" if mode == "epipolar" else "exact_"
    g = torch.Generator(device=dev).manual_seed(SEED)
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    pick = torch.randperm(H * W, generator=g, device=dev)[:ID_RAYS]
    ri = RenderingInput(origins=origins[:, pick], directions=dirs[:, pick],
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = model.encode_image(cam, ri, robot)
        torch.cuda.synchronize()
    timings[tag + "id_encode_ms"] = (time.perf_counter() - t0) * 1e3
    # a small action keeps the target in the regime where the flow is close
    # to linear in the action (the least-squares step linearises at a = 0;
    # at 5x this action the projection's curvature alone leaves ~6%)
    a_star = 0.02 * torch.randn((1, 8), generator=g, device=dev)
    with torch.no_grad():
        target = model.infer_optical_flow(enc, cam, RobotInput(a_star))
    action0 = 1e-3 * torch.randn((1, 8), generator=g, device=dev)
    optimize_actions(model, enc, cam, target, action0=action0, num_iters=5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimize_actions(model, enc, cam, target, action0=action0, num_iters=100)
    torch.cuda.synchronize()
    timings[tag + "inverse_dynamics_ms"] = (time.perf_counter() - t0) * 1e3
    l0, lbest = float(res.losses[0]), float(res.loss)
    print(f"inverse dynamics {mode} ({ID_RAYS} rays): encode "
          f"{timings[tag + 'id_encode_ms']:.1f} ms, 100 Adam steps "
          f"{timings[tag + 'inverse_dynamics_ms']:.1f} ms, loss {l0:.4e} -> {lbest:.4e} "
          f"(bound: best < 0.5 x initial)")
    check(math.isfinite(lbest) and lbest < 0.5 * l0, "inverse dynamics loss did not fall")
    t0 = time.perf_counter()
    a = solve_actions_least_squares(model, enc, cam, target)
    torch.cuda.synchronize()
    timings[tag + "least_squares_ms"] = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        flow = model.infer_optical_flow(enc, cam, RobotInput(a))
    resid = float(torch.linalg.norm(flow - target) / torch.linalg.norm(target))
    print(f"least squares {mode}: {timings[tag + 'least_squares_ms']:.1f} ms, relative flow "
          f"residual {resid:.3e} (bound 2e-2), |a - a*| {float((a - a_star).abs().max()):.3e}")
    check(resid < 2e-2, "least-squares residual above its bound")


# ------------------------------------------------------------------ phase 5

def train_batch(dev):
    """A batch-7 training batch of 480x640 images, random as bench.py's
    _raw_batch makes them (uniform rgb, depth in [1, 4], near 0.5, far 10),
    with the target camera of `cameras` (rotated 10 degrees about a point
    2 m ahead) so that every ray's epipolar segment has length."""
    import torch

    from neural_jacobian_field_torch.training import RawBatch

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    b = TRAIN_B
    cam, _ = cameras(dev)
    return RawBatch(
        ctxt_rgb=torch.rand((b, H, W, 3), generator=g, device=dev),
        ctxt_extrinsics=cam.ctxt_extrinsics.expand(b, 4, 4),
        ctxt_intrinsics=cam.ctxt_intrinsics.expand(b, 3, 3),
        robot_action=0.1 * torch.randn((b, 8), generator=g, device=dev),
        trgt_rgb=torch.rand((b, H, W, 3), generator=g, device=dev),
        trgt_depth=1.0 + 3.0 * torch.rand((b, H, W, 1), generator=g, device=dev),
        trgt_extrinsics=cam.trgt_extrinsics.expand(b, 4, 4),
        trgt_intrinsics=cam.trgt_intrinsics.expand(b, 3, 3),
        near=torch.full((b,), Z_NEAR, device=dev), far=torch.full((b,), Z_FAR, device=dev))


def step_draws(dev, g, rays=None):
    """Explicit randomness for one step: the pixel set and each sampling
    level's stratified jitter for `rays` rays per example (TRAIN_RAYS)."""
    import torch

    from neural_jacobian_field_torch.training.prepare import sample_pixels

    yx = sample_pixels(TRAIN_RAYS, H, W, g, dev)
    draws = tuple(torch.rand((TRAIN_B, rays or TRAIN_RAYS, 257), generator=g, device=dev)
                  for _ in range(2))
    return yx, draws


def step_grads(state, batch, yx, draws, updated):
    """Forward + backward of one train step of the state's stage (no
    optimizer step); returns the parameter gradients by name."""
    from neural_jacobian_field_torch.models.model import StepCtx
    from neural_jacobian_field_torch.training import (
        action_loss, perception_loss, prepare_training_batch)

    model, cfg = state.model, state.cfg
    mi, mt = prepare_training_batch(batch, cfg.rays_per_batch, yx=yx, mode=cfg.mode)
    model.zero_grad(set_to_none=True)
    out = model(mi, train=True, ctx=StepCtx(anneal=1.0, updated=updated, draws=draws))
    loss_fn = perception_loss if cfg.mode == "perception" else action_loss
    loss, _ = loss_fn(out, mt, cfg.loss)
    loss.backward()
    return {k: p.grad.detach().float().clone() for k, p in model.named_parameters()
            if p.grad is not None}


def compare_grads(label, state, batch, yx, draws, groups):
    """One step's gradients with the kernels against the plain versions,
    from the same state and draws. A random field at bf16 is chaotic end to
    end (a K5 tie or one bf16 rounding moves a sample, and the 2^9 NeRF
    frequency turns that into an O(1) change of its features), so the bound
    is loose: per group the two gradients must point the same way (cosine
    > 0.5); their relative l2 difference is printed, beside that of the
    plain versions on inputs nudged by one bf16 step, which measures the
    step's own sensitivity. Returns the names with a kernel gradient."""
    import copy

    import torch

    model = state.model
    saved = copy.deepcopy(model.state_dict())
    kg = step_grads(state, batch, yx, draws, True)
    model.load_state_dict(saved)
    with plain_kernels():
        pg = step_grads(state, batch, yx, draws, True)
        model.load_state_dict(saved)
        # the same sensitivity without any kernel: the plain versions again,
        # with the context images scaled by 1 + 2^-8 (one bf16 step)
        nudged = dataclasses.replace(batch, ctxt_rgb=batch.ctxt_rgb * (1 + 2 ** -8))
        ng = step_grads(state, nudged, yx, draws, True)
    model.load_state_dict(saved)

    def flat(grads, names):
        return torch.cat([grads[k].flatten() for k in names]).double()

    for group in groups:
        names = [k for k in pg if k.startswith(group) and k in kg]
        a, b = flat(kg, names), flat(pg, names)
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-30))
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        nrel = float((flat(ng, names) - b).norm() / b.norm().clamp_min(1e-30))
        print(f"{label} step gradients, kernels vs plain [{group.rstrip('._')}]: "
              f"{len(names)} tensors, |g| {float(a.norm()):.3e} vs {float(b.norm()):.3e}, "
              f"relative l2 difference {rel:.3e}, cosine {cos:.4f} (bound: cosine > 0.5); "
              f"plain vs plain on images nudged by 2^-8: relative l2 {nrel:.3e}")
        check(bool(b.norm() > 0) and cos > 0.5,
              f"{label} gradients of {group} disagree with the plain versions")
    return sorted(kg)


def train_setup(dev, mode, conv_impl="pallas"):
    """The flagship model with seeded weights, its train state, a batch and a
    generator, warmed up on both gates (allocator, cuBLAS)."""
    import torch

    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, train_step

    model = Model(flagship_model_cfg(conv_impl=conv_impl, pixel_feature_mode=mode),
                  compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(SEED)).to(dev)
    cfg = TrainCfg(lr=TRAIN_LR, warm_up_steps=TRAIN_WARMUP, rays_per_batch=TRAIN_RAYS)
    state = create_train_state(model, cfg)
    batch = train_batch(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for updated in (True, True, False, False):
        train_step(state, batch, g, updated)
    torch.cuda.synchronize()
    return model, state, batch, g


def train_phase(dev, timings, mode, conv_impl="pallas"):
    """The stage-1 train step at batch 7 x 256 rays. Returns the launch
    counts of one update step and of one frozen step, and the model's state
    dict after the phase."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.training import host_step_schedule, train_step

    fused = conv_impl == "pallas_fused"
    label = "train fused" if fused else f"train {mode}"
    tag = {(False, "epipolar"): "train_", (False, "exact"): "exact_train_",
           (True, "epipolar"): "fused_train_"}[(fused, mode)]
    model, state, batch, g = train_setup(dev, mode, conv_impl)

    yx, draws = step_draws(dev, g)
    compare_grads(label, state, batch, yx, draws, ("encoder.", "proposal_networks_", "decoder."))

    # launch counts of each step type; then the gradients reach the params
    counts = {}
    for kind, updated in (("frozen", False), ("update", True)):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        counts[kind] = K.launch_counts()
        check_no_legacy(f"{label} {kind} step")
        print(f"{label} launches per {kind} step: {counts[kind]}")
    conv = {"K10" if fused else "K9-fwd": 24, "K9-dgrad": 24, "K9-wgrad": 24, "K5": 1}
    for kind, n_bwd in (("update", 2), ("frozen", 1)):
        if mode == "epipolar":
            want = all_zero_but(dict(conv, **{"K6-fwd": 3, "K6-bwd": 3, "K7-tz-fwd": 3,
                                              "K7-tz-bwd": n_bwd}))
        else:
            want = all_zero_but(dict(conv, **{"K6-fwd": 2, "K6-bwd": 2, "K1-fwd": 2,
                                              "K1-bwd": n_bwd, "K7-fwd": 3, "K7-bwd": n_bwd}))
        check(counts[kind] == want, f"{label} {kind} step launches {counts[kind]} != {want}")
    dead = [name for name, p in model.named_parameters()
            if name.startswith(("encoder.", "decoder.density_head.", "decoder.color_head.",
                                "proposal_networks_"))
            and (p.grad is None or not bool(p.grad.abs().sum() > 0))]
    print(f"{label} gradients: {len(dead)} encoder / density-head / colour-head / "
          f"proposal parameters without a non-zero gradient after an update step {dead[:4]}")
    check(not dead, "a parameter the loss reaches got no gradient")

    # step times (host clock around synchronised steps), peak memory
    torch.cuda.reset_peak_memory_stats(dev)
    times = {True: [], False: []}
    for updated in (False,) * 5 + (True,) + (False,) * 5 + (True,) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        times[updated].append((time.perf_counter() - t0) * 1e3)
    upd_ms, frz_ms = statistics.median(times[True]), statistics.median(times[False])
    cycle_s = (5 * frz_ms + upd_ms) / 1e3
    timings[tag + "update_step_ms"] = upd_ms
    timings[tag + "frozen_step_ms"] = frz_ms
    timings[tag + "cycle_rays_per_s"] = 6 * TRAIN_B * TRAIN_RAYS / cycle_s
    timings[tag + "peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{label} step (batch {TRAIN_B} x {TRAIN_RAYS} rays, 480x640 context, bf16, "
          f"{conv_impl}): update {upd_ms:.2f} ms, frozen {frz_ms:.2f} ms (medians of "
          f"{len(times[True])} / {len(times[False])}); 5 frozen + 1 update cycle "
          f"{timings[tag + 'cycle_rays_per_s']:.1f} rays/s; peak "
          f"{timings[tag + 'peak_mem_gib']:.2f} GiB")
    if fused and "train_update_step_ms" in timings:
        print(f"{label} vs pallas (epipolar, this call): update {upd_ms:.2f} vs "
              f"{timings['train_update_step_ms']:.2f} ms, frozen {frz_ms:.2f} vs "
              f"{timings['train_frozen_step_ms']:.2f} ms")

    # the loss falls over the loss steps on this batch at one fixed pixel
    # set (the schedule's own gate; the stratified draws change every step)
    fixed_yx, _ = step_draws(dev, g)
    losses = []
    for _ in range(LOSS_STEPS):
        updated, _ = host_step_schedule(state.step, state.steps_since_update,
                                        model.cfg.rendering)
        m = train_step(state, batch, g, updated, yx=fixed_yx)
        losses.append(float(m["loss/total"]))
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    print(f"{label} loss over {len(losses)} steps: {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"mean of the first 3 {first:.5f}, of the last 3 {last:.5f} (bound: finite, "
          f"last < first)")
    check(all(math.isfinite(v) for v in losses) and last < first, "the train loss did not fall")
    timings[tag + "loss_first3"], timings[tag + "loss_last3"] = first, last
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, state, batch
    torch.cuda.empty_cache()
    return counts, trained


# ------------------------------------------------------------------ phase 6

def action_batch(dev, supervision):
    """`train_batch` with the stage-2 targets bench.py's _raw_batch adds: a
    standard-normal flow per pixel, or TRACKS tracks per example at random
    pixels with standard-normal motion, all visible."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, batch = TRAIN_B, train_batch(dev)
    if supervision == "flow":
        return dataclasses.replace(batch, flow=torch.randn((b, H, W, 2), generator=g,
                                                            device=dev))
    return dataclasses.replace(
        batch, pixel_selector=torch.randint(0, H * W, (b, TRACKS), generator=g, device=dev),
        pixel_motion=torch.randn((b, TRACKS, 2), generator=g, device=dev),
        pixel_visible_mask=torch.ones((b, TRACKS), device=dev))


def action_setup(dev, mode, supervision, stage1=None):
    """The flagship model under pallas_fused, its stage-2 train state
    (warm-started from the stage-1 state dict `stage1` when given), an
    action batch and a generator."""
    import torch

    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = Model(flagship_model_cfg(conv_impl="pallas_fused", pixel_feature_mode=mode),
                  compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(SEED + 6)).to(dev)
    cfg = TrainCfg(mode="action", lr=ACTION_LR, warm_up_steps=TRAIN_WARMUP,
                   rays_per_batch=TRAIN_RAYS)
    state = create_train_state(model, cfg, init_params=stage1)
    return model, state, action_batch(dev, supervision), torch.Generator(
        device=dev).manual_seed(SEED + 7)


def action_phase(dev, timings, mode, supervision, stage1):
    """The stage-2 train step under pallas_fused, warm-started from the
    stage-1 state dict `stage1`: flow at batch 7 x 256 rays, or tracks at
    7 x TRACKS. Returns the launch counts of one step."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.training import host_step_schedule, train_step

    label = f"action {mode}" if supervision == "flow" else "action tracks"
    tag = label.replace(" ", "_") + "_"
    rays = TRAIN_RAYS if supervision == "flow" else TRACKS
    model, state, batch, g = action_setup(dev, mode, supervision, stage1)
    head = "decoder.jacobian_head."
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    check(trainable and all(n.startswith(head) for n in trainable),
          f"{label}: the trainable parameters are not the Jacobian head's: {trainable[:4]}")
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not n.startswith(head)}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()}

    yx, draws = step_draws(dev, g, rays)
    reached = compare_grads(label, state, batch, yx, draws, (head,))
    check(reached == sorted(trainable), f"{label}: gradients on {reached[:4]}..., not the head's")

    # the loss on a fixed batch and pixel set: the near-zero head makes the
    # first steps' loss artificially low, so it must fall from its early peak
    fixed_yx, _ = step_draws(dev, g, rays)
    losses = []
    for _ in range(LOSS_STEPS):
        updated, _ = host_step_schedule(state.step, state.steps_since_update,
                                        model.cfg.rendering)
        losses.append(float(train_step(state, batch, g, updated, yx=fixed_yx)["loss/total"]))
    peak, last = max(losses[:5]), statistics.mean(losses[-3:])
    print(f"{label} loss over {len(losses)} steps (lr {ACTION_LR:g}): "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; peak of the first 5 {peak:.5f}, mean of the last 3 {last:.5f} "
          f"(bound: finite, last < peak)")
    check(all(math.isfinite(v) for v in losses) and last < peak,
          f"{label}: the loss did not fall from its early peak")
    timings[tag + "loss_peak5"], timings[tag + "loss_last3"] = peak, last

    counts = {}
    want = all_zero_but({"K10": 24, "K6-fwd": 3, "K5": 1, "K7-tz-fwd": 3, "K7-tz-bwd": 1}
                        if mode == "epipolar" else
                        {"K10": 24, "K6-fwd": 2, "K1-fwd": 2, "K5": 1, "K7-fwd": 3,
                         "K7-bwd": 1})
    for kind, updated in (("frozen", False), ("update", True)):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        counts[kind] = K.launch_counts()
        check_no_legacy(f"{label} {kind} step")
        print(f"{label} launches per {kind}-gate step: {counts[kind]}")
        check(counts[kind] == want, f"{label} {kind} step launches {counts[kind]} != {want}")

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(8):
        updated, _ = host_step_schedule(state.step, state.steps_since_update,
                                        model.cfg.rendering)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    timings[tag + "step_ms"] = step_ms
    timings[tag + "rays_per_s"] = TRAIN_B * rays / step_ms * 1e3
    timings[tag + "peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{label} step (batch {TRAIN_B} x {rays} rays, 480x640 context, bf16, "
          f"pallas_fused): {step_ms:.2f} ms (median of {len(times)}), "
          f"{timings[tag + 'rays_per_s']:.1f} rays/s; peak {timings[tag + 'peak_mem_gib']:.2f} GiB")

    changed = [n for n, p in model.named_parameters()
               if n in frozen0 and not torch.equal(p.detach(), frozen0[n])]
    means = [n for n in stats0 if n.endswith("running_mean")]
    still = [n for n in means if torch.equal(dict(model.named_buffers())[n], stats0[n])]
    head_moved = any(not torch.equal(p.detach(), stage1[n]) for n, p in model.named_parameters()
                     if n.startswith(head))
    print(f"{label} after {state.step} steps: {len(frozen0) - len(changed)}/{len(frozen0)} "
          f"parameters outside {head} bit-identical to the warm start "
          f"(passed={not changed}); {len(means) - len(still)}/{len(means)} BatchNorm running "
          f"means moved; Jacobian head moved={head_moved}")
    check(not changed and not still and head_moved,
          f"{label}: frozen parameters moved {changed[:4]}, or running stats {still[:4]} "
          f"or the head did not")
    del model, state, batch
    torch.cuda.empty_cache()
    return counts["update"]


def profile_train(dev, mode, top=15):
    """--profile: torch.profiler around one frozen and one update train step
    (after the warm-up) of stage 1 in the given feature mode, of stage 1
    under pallas_fused ("fused", epipolar), or of stage 2 ("action",
    epipolar, flow; its two steps differ in the proposal gate only). Per
    step: the traced wall time (the step's first host event to its last
    device event), the device's busy time (the union of its kernel, copy and
    set intervals, so overlapping work counts once), the idle share 1 - busy
    / wall, the number of device events, the device time under the
    optimizer step, the `top` kernels by device time, and the device time
    and launches by kernel of the stride-1 conv kernels (K9-fwd or K10,
    K9-dgrad, K9-wgrad and their ordered sums), the K7 trunks, K1-bwd and
    K5."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_jacobian_field_torch.training import train_step

    if mode == "action":
        _, state, batch, g = action_setup(dev, "epipolar", "flow")
        for updated in (True, False):
            train_step(state, batch, g, updated)
    elif mode == "fused":
        _, state, batch, g = train_setup(dev, "epipolar", "pallas_fused")
    else:
        _, state, batch, g = train_setup(dev, mode)
    for kind, updated in (("frozen", False), ("update", True)):
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_step(state, batch, g, updated)
            torch.cuda.synchronize()
        events = prof.events()
        # a record_function range (the optimizer's, say) is mirrored on the
        # device timeline under its host name; it is a span, not work
        host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
        dev_ev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                         and e.name not in host_names), key=lambda e: e.time_range.start)
        check(dev_ev, "the profiler recorded no device event")
        busy, end = 0.0, -math.inf
        for e in dev_ev:  # union of the device intervals, in microseconds
            s, t = e.time_range.start, e.time_range.end
            busy += max(0.0, t - max(s, end))
            end = max(end, t)
        host_start = min(e.time_range.start for e in events
                         if e.device_type == DeviceType.CPU)
        wall = end - host_start
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in dev_ev:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
        opt_us = sum(getattr(a, "device_time_total", 0.0) for a in prof.key_averages()
                     if a.key.startswith("Optimizer.step"))
        print(f"profile {mode} {kind} step: traced wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.4f}, {len(dev_ev)} device "
              f"events, optimizer step {opt_us / 1e3:.3f} ms of device time")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"profile {mode} {kind}   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{n:<5d} "
                  f"{name[:90]}")
        # the stride-1 conv kernels (K9-fwd / K10, K9-dgrad, K9-wgrad) and
        # their ordered-sum passes; the K7 trunk kernels (forward, the
        # backward's gradient chain, weight-gradient pass and ordered sums,
        # or the legacy ones); K1-bwd's stages; K5
        for label, rx in (
                ("conv", r"(conv3x3_(tma|legacy)_kernel|wgrad_(tma|legacy)_kernel|"
                         r"stats_sum_kernel|sum_splits_kernel)(<[^>]*>)?"),
                ("K7", r"(field_mlp_(wg|fwd|bwd_chain|bwd|dw|dwz)_kernel|"
                       r"reduce_(bwd|partials|splits)_kernel)(<[^>]*>)?"),
                ("K1-bwd", r"(bucket_(count|scan|place)_kernel|segment_sum_kernel|"
                           r"merge_parts_kernel)(<[^>]*>)?"),
                ("K5", r"pdf_resample_kernel")):
            group = collections.defaultdict(lambda: [0.0, 0])
            for name, (us, n) in by_name.items():
                m = re.search(rx, name)
                if m:
                    group[m.group(0)][0] += us
                    group[m.group(0)][1] += n
            print(f"profile {mode} {kind} {label} kernels: "
                  f"{sum(v[0] for v in group.values()) / 1e3:.3f} ms in "
                  f"{sum(v[1] for v in group.values())} launches; "
                  + "; ".join(f"{k} {v[0] / 1e3:.3f} ms x{v[1]}"
                              for k, v in sorted(group.items(), key=lambda kv: -kv[1][0])))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", nargs="?", const="epipolar",
                        choices=MODES + ("fused", "action"),
                        help="only profile one frozen and one update train step of the given "
                             "feature mode, of the epipolar step under pallas_fused (fused) or "
                             "of the stage-2 step (action) with torch.profiler, and print "
                             "where the device time "
                             "goes")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        from neural_jacobian_field_torch.ops import kernels as K
        from neural_jacobian_field_torch.ops.kernels.build import load_kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3

    try:
        t_start = time.perf_counter()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card = card_line()
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("TF32 off for matmuls and cuDNN convolutions (float32 references are full "
              "float32)")
        lib = load_kernels()
        print(f"kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
        kernel = ""  # the entry function ptxas reports on
        for line in lib.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = kernel_name(m.group(1))
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()} [{kernel}]")
        sass = sass_counts(lib.path)
        for fn, (hgmma, utmaldg, hmma) in sass.items():
            print(f"  SASS {fn[:96]}: HGMMA {hgmma} UTMALDG {utmaldg} HMMA {hmma}")
        tma = {fn: c for fn, c in sass.items()
               if re.search(r"tma_kernel|wg_kernel|bwd_chain_kernel|field_mlp_dw_kernel", fn)}
        check(not sass or (sum("wg_kernel" in fn for fn in tma) == 2
                           and sum("bwd_chain_kernel" in fn for fn in tma) == 2
                           and sum("field_mlp_dw_kernel" in fn for fn in tma) == 1
                           and all(c[0] and c[1] and not c[2] for c in tma.values())),
              "a K9 TMA kernel or K7 wgmma kernel lacks HGMMA or UTMALDG in its SASS, or kept "
              "HMMA")
        print(f"SASS: {len(tma)} TMA / wgmma kernels (K9, the K7 forward and the K7 backward's "
              f"two passes) with HGMMA and UTMALDG" if sass else
              "SASS: no cuobjdump in this toolkit")
        if args.profile:
            profile_train(dev, args.profile)
            return 0

        rows = kernel_checks(dev)
        rows.update(k10_checks(dev))
        rows.update(backward_kernel_checks(dev))
        timings, paths = {}, {}
        cam, robot = cameras(dev)
        for mode in MODES:
            model = build_model(dev, mode)
            paths[("" if mode == "epipolar" else "exact_") + "serve"] = serve_phase(
                dev, model, cam, robot, timings, mode)
            inverse_dynamics_phase(dev, model, cam, robot, timings, mode)
            del model
            torch.cuda.empty_cache()
        timings["serve_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        for mode in MODES:
            counts, _ = train_phase(dev, timings, mode)
            prefix = "" if mode == "epipolar" else "exact_"
            paths[prefix + "train_update"] = counts["update"]
            paths[prefix + "train_frozen"] = counts["frozen"]
        counts, stage1 = train_phase(dev, timings, "epipolar", "pallas_fused")
        paths["fused_train_update"] = counts["update"]
        paths["fused_train_frozen"] = counts["frozen"]
        for mode, supervision in (("epipolar", "flow"), ("exact", "flow"),
                                  ("epipolar", "tracks")):
            name = "action_" + ("tracks" if supervision == "tracks" else mode + "_flow")
            paths[name] = action_phase(dev, timings, mode, supervision, stage1)
        del stage1
        timings["script_s"] = time.perf_counter() - t_start
        print("timings: " + json.dumps({k: round(v, 4) for k, v in timings.items()}))
        print("launches by path: " + json.dumps(paths))
        unused = [n for n in K.KERNELS if not sum(c[n] for c in paths.values())]
        check(not unused, f"kernels launched by no main path: {unused}")
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[name] for c in paths.values()), **rows[name]}
        for name, (_, _, src, rep) in K.KERNELS.items()]}
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
