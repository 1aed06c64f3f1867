#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # every check below
    python3 chip_smoke.py --profile [MODE]  # only: where a train step's device
                                            # time goes, eager and captured
                                            # (MODE epipolar, exact, fused,
                                            # action or transformer)
    python3 chip_smoke.py --profile serve [MODE]  # only: one render and one
                                            # 100-step solve, eager and
                                            # captured (MODE epipolar or exact)
    python3 chip_smoke.py --determinism     # only: whether the stage-1 steps
                                            # repeat bit for bit, the ops that
                                            # sum with atomics, the cycle's rays/s
    python3 chip_smoke.py --determinism --torch-deterministic
                                            # the same under PyTorch's own
                                            # deterministic algorithms

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
     45x80 map (a 720x1280 image's layer3, on a line of its own);
     K1-bwd-rows, K1-bwd's scatter generalised (the fixed-order backward of
     the packed-row, knot and lookup gathers), at the exact mode's
     fine-level gather (7 x 65,536 rows of 512 bf16 onto 240x320, bf16
     out) and, on lines of their own, the ids one eager flagship step and
     one e2e step hand it (exact fine and mid, knots fine, mid and coarse,
     the e2e lookups), each beside its previous design, timed in turns,
     the pyramid's 2x upsampling (Q = 4 weighted corners, one table) and
     the interlevel loss (float32, 1,792 rays of 257 one-wide rows), each
     twice for identical bits, the last
     two the routes that K1-bwd-upsample and K1-bwd-small took over; those
     two bit for bit against their plain versions on the CPU and twice for
     identical bits, with the library call and the K1-bwd-rows route timed
     beside them: K1-bwd-upsample at the flagship's 2x upsampling (7 x
     240x320 x 64 bf16) and the concat layout's three (64, 128, 256
     float32 channels from 2x, 4x, 8x smaller maps onto 240x320), K1-bwd-
     small at the interlevel loss and on its ids shuffled; PyTorch's
     max_pool2d backward at the stem's and the 2D UNet's shapes on tied
     inputs, twice for identical bits; K10, K5,
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
     their bound over it and the host's time to enqueue one call, K6-fwd
     that host time too);
  3. serving, per mode, each entry point eager (inside
     model.programs.eager()) and through its captured CUDA graphs
     (inference/programs.py), timed both ways, the captured outputs equal
     to the eager ones bit for bit and two replays bit-identical: the
     encoder; a full 480x640 target view rendered in 2048-ray chunks from a
     480x640 context image (launch counters reset just before the captured
     run, read just after: counted through replay, and equal to the eager
     run's); the whole render as one graph of 150 chunks against the chunk
     program's replays; replays that follow a new image, camera and action,
     weights loaded in place (the same programs) and reassigned (captured
     again); then one chunk again, eagerly, stage by stage, with the plain
     versions swapped in;
  4. inverse dynamics on 4096 rays, per mode, eager and captured as in 3:
     encode_image, a model-realisable target flow, 100 Adam steps, and the
     least-squares solve; the solvers' replays follow a new target flow;
  5. training, per mode: the stage-1 train step at batch 7 x 256 rays with
     480x640 context images (bf16, forward + backward + Adam), eager
     (train_step): launch counts of an update step and of a frozen step
     (counters reset before each; two trunks forward, the Jacobian trunk
     does not run in stage 1), non-zero gradients on every encoder,
     density-head, colour-head and proposal parameter, update / frozen step
     times and the rays/s of one 5-frozen + 1-update cycle, peak memory, one
     step's parameter gradients with the kernels against the plain
     versions; then the steps as CUDA graphs (training/train.py:
     make_train_step, make_multi_train_step), from the eager state loaded
     into a fresh model: three steps (update, frozen, frozen) captured
     against the same three steps run eagerly five times (metrics,
     parameters, BatchNorm statistics, Adam's state: the eager runs
     bit-identical in every tensor and no op on a step summing with atomics
     (ops_with_atomics; the gathers, the stem's max-pool and the upsampling
     take fixed-order backwards, cuDNN its deterministic algorithms), and
     the captured steps equal to them bit for bit; compare_captured's rule
     for tensors where eager runs differ, which stage 2 keeps: the captured
     tensor's l2 distance to the nearest eager run over the eager runs'
     spread at most 10, its median over the tensors at most 1), launch
     counts through replay, replayed
     update / frozen step times, the cycle as six replays and as one 6-step
     program (rays/s), the cycle's peak memory against the eager steps'
     (bound 1.3x), 30 steps through MultiStepDispatch past a short warm-up,
     and a loss that falls over 20 captured steps on one batch; then the
     same in epipolar mode with conv_impl="pallas_fused" (K10 in place of
     K9-fwd; lines "train fused");
  6. stage 2 (action), warm-started from that stage-1 model under
     pallas_fused: flow supervision at batch 7 x 256 rays in both modes and
     tracks at 7 x 1472 in epipolar mode (lines "action epipolar|exact",
     "action tracks"): launch counts per step, the Jacobian head's gradients
     with the kernels against the plain versions, eager step times, rays/s
     and peak memory; then captured as in 5 (three steps against five
     eager runs, counts through replay, replayed step times and peak
     memory), a
     loss that falls from its early peak over 20 captured steps on a fixed
     batch at lr 1e-4, every parameter outside the decoder's action pattern
     (action_param_pattern: "jacobian_head" here, `action_names`) bit for
     bit unchanged, the trainable set exactly those parameters, and the
     BatchNorm running means moved (with another norm: no running
     statistics at all; `running_means_gate`);
  7. the concat layout's shapes: K7-fwd and K7-bwd with one latent level,
     128 wide at the e2e step's 4,096 points and at 458,752, 512 wide at
     458,752, on the wgmma kernels, against the plain versions and the
     backward against the legacy kernel too (lines "K7-fwd one level" /
     "K7-bwd one level", beside the K7 rows); K9-fwd, K9-dgrad and K9-wgrad
     at the e2e drive's 4x12x16x64 convs;
  8. the training CLI at full width (lines "cli"): which of PyYAML, Pillow,
     matplotlib and the native decoder the machine has; a 480x640
     synthetic scene (3 cameras x 3 trajectories x 4 frames, action_dim
     16) written by the port; `train()` in process at dataset_allegro +
     model_allegro (bf16, K9 convs, 6 steps per call, proposal warm-up 12,
     198 steps: log points at 96 and 192, a validation video of 2 frames
     at 195, a checkpoint at 198), its first steady dispatch (steps
     96-102) under torch.profiler (the device idle share of a steady
     window; the logged window 102-192 leaves it out); three
     steps replayed after the validation render against three eager runs
     (as in 5); the loader alone in both stages' modes (batches/s); stage
     2 (flow) warm-started
     from the checkpoint, its frozen parameters bit for bit against it; a
     4-step tracks run. Printed: the logged rays/s beside phase 5's
     6-step program, the launches of each run (paths cli_stage1,
     cli_stage2, cli_tracks), the captured programs, the frames written,
     the peak reserved memory. Gates: finite losses, the steady programs
     reached, the frames, the freezing (stage 2 moved only the decoder's
     action parameters, by the pattern: `cli_freezing_gate`), the counts
     (each kernel of a stage's steps at least its steps times phase 5's
     per-step count), the legacy counters;
  9. the e2e drive (neural_jacobian_field_torch.verify_e2e) on the card in
     float32 and in bf16 (K9 convs, K7 with one 128-wide level), its checks
     as gates, the two loss curves side by side every 10 steps (lines
     "e2e"; path e2e);
  10. other decoders and norms (lines "transformer", "defaults",
     "flow_mlp"): model_allegro_transformer as the YAML builds it (bf16,
     epipolar, K9 convs, BatchNorm): the 480x640 render eager against
     captured with its launches, inverse dynamics as in 4, stage 1 (three
     steps captured against five eager runs, launches, the cycle's rays/s
     and peak memory), stage 1 again with remat=True (its peak memory, its
     captured steps held to the remat-off eager runs), stage 2 as in 6
     (freezing by "jacobian"), and the CLI at model=model_allegro_transformer
     on phase 8's scene (96 stage-1 steps, 96 stage-2 steps warm-started
     from its checkpoint); the JAX defaults, Model(make_model_cfg())
     (float32, exact, group norm, cuDNN convs, plain trunks): the render
     eager against captured (K6-fwd, K1-fwd, K5) and a stage-1 step eager
     and captured (K1-bwd, K6-bwd) with finite non-zero gradients on every
     encoder parameter; flow_mlp: one render chunk, encode_image refused,
     stage-2 steps captured against eager, freezing by "flow_head";
  11. tools and flow (lines "tools", "raft"): load_model on phase 8's
     stage-2 checkpoint (bf16, its overrides), every parameter and
     BatchNorm buffer bit for bit the file's; the render camera through
     parse_camera_json from camera jsons written from phase 8's scene; a
     480x640 render through the captured programs (counted through replay:
     K9-fwd, K6-fwd, K5, K7-tz-fwd, no legacy kernel) and its
     joint-sensitivity map [1, 8, 480, 640] in [0, 1] and image; a
     reference checkpoint fabricated at the flagship's widths (exact mode,
     jacobian_mlp, action_dim 8) through port_reference_checkpoint, loaded
     with strict=True, one 2048-ray chunk (K1-fwd, K7-fwd); RAFT at
     raft_large's widths from a fabricated torchvision state dict:
     compute_video_flow forward and backward on a 9-frame 480x640 video
     (8 pairs in one chunk, float32), two runs bit for bit, one pair
     against the module in float64 (float32 within 1e-4 of the largest
     flow component, the same pair under cuDNN's TF32 beyond it), ms per
     pair, peak memory, TFLOP per
     pair (FlopCounterMode); a draw_pixel_motion overlay where cv2 is
     installed;
  12. timings and peak memory;
  13. the 2D Jacobian-field family at full width (lines "2d"): the unet
     (depth 3, 32 filters) and transformer (ViT-S/14 and a depth-3 UNet
     decoder on 387 channels) configurations of configurations2d/, seeded,
     252x252, batch 12, float32: the Jacobian map and flow captured
     (jacobian2d.predict_2d) against eager bit for bit, three train steps
     captured against five eager runs (exact: bit for bit, no atomic sums),
     replayed step ms, steps/s and peak memory, a loss that falls over 20
     captured steps on one batch, the transformer's dino parameters bit
     for bit unchanged, one step's float32 gradients (TF32 off) within 1e-5
     of float64's; train2d in process for pusher_only and left_finger, 60
     steps each on synthetic trajectories written at 252x252, the .npz
     loaded back bit for bit; tutorial 3's closed loop for 20 steps on the
     trained pusher (its pixel error per step); the dinov2 ingest of a
     fabricated ViT-S/14 hub state dict, loaded strict. The 2D family runs
     no hand-written kernel (its convolutions are cuDNN's, as they were
     XLA's in JAX).
Each phase prints `phase <n> <name>: ok, <s> s` as it ends, so a failed
run's log shows where it stopped. Every main path also checks that no K9
wrapper went to its legacy kernel (C or Cout not a multiple of 8), and no
K7 wrapper to its legacy WMMA
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
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
# K1-bwd-rows' kernels by name: each tile's entries sorted by texel block,
# each block's by texel, then each (texel block, image, slab) summed
K1_BWD_ROWS_STAGES = {"bucket": r"rows_bucket_kernel", "block sort": r"rows_sort_kernel",
                      "block sums": r"rows_sum_kernel"}


class PhaseError(RuntimeError):
    pass


def phase_line(n, name, t0):
    """The line that says a phase ended: `phase <n> <name>: ok, <s> s`."""
    print(f"phase {n} {name}: ok, {time.perf_counter() - t0:.1f} s", flush=True)


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
    of the kernels whose names match each: (total, {label: ms}). Where the
    profiler delivers no device event in four traces, NaN (not measured),
    said so on a line of its own."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace that caught no device event is taken again, after a pause: the
    # profiler now and then delivers no device activity for a whole trace
    for attempt in range(4):
        if attempt:
            time.sleep(0.5)
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
    if us <= 0:
        # the profiler delivered no device event in any trace: no device
        # time, so every device figure derived from this call prints nan
        print("   (torch.profiler delivered no device event in 4 traces: device time not "
              "measured, nan)")
        return math.nan if groups is None else (math.nan, {label: math.nan for label in groups})
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
    row, dev_sum, host_sum = Row(), 0.0, 0.0
    for hh, ww, c in ((240, 320, 128), (60, 80, 128), (30, 40, 256)):
        x = torch.randn((1, hh, ww, c), generator=g, device=dev).to(torch.bfloat16)
        got, want = K.pack_2x2_flat(x), K.pack_2x2_flat_plain(x)
        err = float((got.float() - want.float()).abs().max())
        print(f"K6-fwd 1x{hh}x{ww}x{c}: max_abs_err {err:.3e} (tol: 0, a copy)")
        check(err == 0.0, "K6-fwd disagrees with its plain version")
        k_ms = cuda_time_ms(lambda: K.pack_2x2_flat(x))
        p_ms = cuda_time_ms(lambda: K.pack_2x2_flat_plain(x))
        d_ms = device_ms(lambda: K.pack_2x2_flat(x))
        host = host_ms(lambda: K.pack_2x2_flat(x))
        dev_sum, host_sum = dev_sum + d_ms, host_sum + host
        print_times("", k_ms, p_ms, extra=f" (device {d_ms:.4f}, host enqueue {host:.4f} per "
                                          f"call)")
        row.add(err, k_ms, p_ms, nbytes(x, got))
    rows["K6-fwd"] = row.record()
    print(f"K6-fwd fine + mid + coarse: kernel {row.ms:.4f} ms, device {dev_sum:.4f} ms, host "
          f"enqueue {host_sum:.4f} ms")

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


def concat_layout_checks(dev):
    """K7-fwd and K7-bwd with ONE latent level, the concat layout's map as the
    trunks get it (float32, from the bilinear lookup): 128 wide (the e2e
    configuration, num_layers 2) at its train step's 4 x 128 rays x 8 samples
    and at the flagship step's 7 x 256 x 256, and 512 wide (num_layers 4,
    feature_layout concat) at the latter; each trunk of d_out 1, 16, 24
    against its plain version, on the wgmma kernels (fwd_plan / bwd_plan not
    legacy, no legacy launch but the comparison's), the backward also against
    the legacy kernel forced onto the same inputs (within 1e-4 of scale).
    Lines of their own beside the K7 rows: error, tolerance, kernel / plain /
    device ms, bound. Then K9-fwd, K9-dgrad and K9-wgrad at the e2e
    configuration's 64-channel convs."""
    import torch

    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.ops.kernels import field_mlp

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    cfg = MlpCfg(n_blocks=5, d_hidden=128, combine_layer=3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    K.reset_launch_counts()
    forced = 0  # backward calls sent to the legacy kernel on purpose
    for width, npts in ((128, 4 * 128 * 8), (128, TRAIN_B * TRAIN_RAYS * 256),
                        (512, TRAIN_B * TRAIN_RAYS * 256)):
        z = torch.randn((npts, width), generator=g, device=dev)
        x = (torch.rand((npts, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
        for d_out in (1, 16, 24):
            params = trunk_params(g, dev, d_out, width)
            fplan = field_mlp.fwd_plan(npts, 63, 128, 5, 3, d_out, (width,), sms=sms)
            bplan = field_mlp.bwd_plan(npts, 63, 128, 5, 3, d_out, (width,), sms=sms)
            check(not fplan.legacy and not bplan.legacy,
                  f"K7 one level {width}: the plan takes the legacy kernel")
            got = K.fused_resnet_fc(params, cfg, z, x, d_out)
            want = K.fused_resnet_fc_plain(params, cfg, z, x, d_out)
            ferr, fscale = float((got - want).abs().max()), float(want.abs().max())
            gy = torch.randn((npts, d_out), generator=g, device=dev)
            grads, dz = K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out)
            pgrads, pdz = K.fused_resnet_fc_bwd_plain(params, cfg, z, x, gy, d_out)
            # the legacy kernel forced onto the same inputs: it recomputes the
            # same bf16 forward (the same ReLU masks), so the wgmma passes
            # must sit within 1e-4 of it; against the plain version both
            # may sit as far as the legacy kernel does (a recomputed bf16
            # activation rounded the other way flips a mask: a few 1e-2 of
            # scale at a few thousand points), or the three-level rows'
            # bounds where those are larger
            bwd_plan = field_mlp.bwd_plan
            field_mlp.bwd_plan = lambda *a, **k: field_mlp.legacy_bwd_plan(npts, sms)
            try:
                lgrads, _ = K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out)
            finally:
                field_mlp.bwd_plan = bwd_plan
            forced += 1

            def worst(fn, a, b):
                return max(fn(a[k][n], v) for k, p in b.items() for n, v in p.items())

            def l2(a, b):
                return float((a - b).norm() / b.norm().clamp_min(1e-30))

            vs_legacy = worst(rel_err, grads, lgrads)
            leaf, leaf_l2 = worst(rel_err, grads, pgrads), worst(l2, grads, pgrads)
            leaf_tol = max(2e-2, worst(rel_err, lgrads, pgrads) + 1e-4)
            l2_tol = max(1e-2, worst(l2, lgrads, pgrads) + 1e-4)
            dzl2 = float((dz.float() - pdz.float()).norm() / pdz.float().norm())
            berr = max(float((grads[k][n] - v).abs().max()) for k, p in pgrads.items()
                       for n, v in p.items())
            ok = (bool(torch.isfinite(got).all()) and ferr <= 1e-2 * fscale and vs_legacy <= 1e-4
                  and leaf <= leaf_tol and leaf_l2 <= l2_tol and dzl2 <= 1e-2)
            flops = npts * 2.0 * (63 * 128 + 10 * 128 * 128 + 128 * d_out + width * 3 * 128)
            fbytes = nbytes(z, x) + npts * d_out * 4
            bbytes = 2 * nbytes(z) + nbytes(x, gy)
            times = []
            for fn in (lambda: K.fused_resnet_fc(params, cfg, z, x, d_out),
                       lambda: K.fused_resnet_fc_plain(params, cfg, z, x, d_out),
                       lambda: K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out),
                       lambda: K.fused_resnet_fc_bwd_plain(params, cfg, z, x, gy, d_out)):
                times.append(cuda_time_ms(fn, reps=3, warmup=1))
            fdev = device_ms(lambda: K.fused_resnet_fc(params, cfg, z, x, d_out), reps=3)
            bdev = device_ms(lambda: K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out), reps=3)
            fbound = max(fbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
            bbound = max(bbytes / PEAK_BYTES_PER_S, 3 * flops / PEAK_BF16_FLOPS) * 1e3
            print(f"K7-fwd one level {width} N={npts} d_out={d_out}: max_abs_err {ferr:.3e} "
                  f"rel_to_scale {ferr / fscale:.3e} (tol 1e-2 of scale); ms kernel "
                  f"{times[0]:.4f} plain {times[1]:.4f} device {fdev:.4f} bound {fbound:.4f}")
            print(f"K7-bwd one level {width} N={npts} d_out={d_out}: dW/db max_abs_err "
                  f"{berr:.3e}; against the legacy kernel worst leaf {vs_legacy:.3e} of scale "
                  f"(tol 1e-4); against the plain version worst leaf {leaf:.3e} of scale (tol "
                  f"{leaf_tol:.3e}), {leaf_l2:.3e} in l2 (tol {l2_tol:.3e}); dz {dzl2:.3e} in "
                  f"l2 (tol 1e-2); ms kernel {times[2]:.4f} plain {times[3]:.4f} device "
                  f"{bdev:.4f} bound {bbound:.4f}")
            check(ok, f"K7 one level {width} N={npts} d_out={d_out} disagrees with its plain "
                  "version")
            del got, want, grads, dz, pgrads, pdz, lgrads
        del z, x
    # K9 at the e2e configuration's stride-1 convs: layer1 of a 48x64 image,
    # batch 4, 64 channels (the e2e drive's bf16 run launches them)
    x = torch.randn((4, 12, 16, 64), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 64, 64), generator=g, device=dev) / 24.0).to(torch.bfloat16)
    gy = torch.randn((4, 12, 16, 64), generator=g, device=dev).to(torch.bfloat16)
    for name, fn, plain in (("K9-fwd", lambda: K.conv3x3_s1(x, w),
                             lambda: K.conv3x3_s1_plain(x, w)),
                            ("K9-dgrad", lambda: K.conv3x3_s1_dgrad(gy, w),
                             lambda: K.conv3x3_s1_dgrad_plain(gy, w)),
                            ("K9-wgrad", lambda: K.conv3x3_s1_wgrad(x, gy),
                             lambda: K.conv3x3_s1_wgrad_plain(x, gy))):
        got, want = fn(), plain()
        err = (got.float() - want.float()).abs()
        if name == "K9-wgrad":  # float32 sums reordered
            ok, tol = rel_err(got, want) <= 1e-4, "1e-4 of scale"
        else:  # one bf16 rounding of a float32 sum on each side
            ok, tol = bool((err <= 2.0 ** -7 * want.float().abs() + 1e-3).all()), \
                "2^-7|ref| + 1e-3 per element"
        print(f"{name} at the e2e shape 4x12x16x64: max_abs_err {float(err.max()):.3e} "
              f"rel_to_scale {rel_err(got, want):.3e} (tol {tol}); ms kernel "
              f"{cuda_time_ms(fn):.4f} plain {cuda_time_ms(plain):.4f} device "
              f"{device_ms(fn):.4f}")
        check(ok, f"{name} at the e2e shape disagrees with its plain version")
    legacy = K.legacy_launch_counts()
    check(legacy["K7-bwd"] == forced and not any(v for k, v in legacy.items() if k != "K7-bwd"),
          f"K7 one level: legacy launches {legacy} beyond the {forced} forced ones")
    K.reset_launch_counts()
    torch.cuda.empty_cache()


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
    rows.update(row_scatter_checks(dev))  # its own generator: g's draws stay the K7 rows'
    torch.cuda.empty_cache()
    rows.update(fixed_order_checks(dev))  # likewise
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

def rounded_err(got, ref) -> float:
    """For an output rounded to bf16 from float32 sums: max over elements of
    |got - ref| less bf16's rounding of the value (at most 2^-8 of it),
    over max |ref|; ref the float32 sums."""
    ref = ref.float()
    excess = ((got.float() - ref).abs() - ref.abs() * 2.0 ** -8).clamp_min(0.0)
    return float(excess.max() / ref.abs().max().clamp_min(1e-30))


def record_row_scatter(fn):
    """Run fn() with gather_rows's backward recording what it hands
    K1-bwd-rows: -> [(idx [B, n, 1] on the card, k, c, g's dtype)] in call
    order."""
    from neural_jacobian_field_torch.ops import deterministic

    calls, k1 = [], deterministic.k1

    class Recording:  # the kernels' module as gather_rows's backward sees it
        def __getattr__(self, name):
            return getattr(k1, name)

        def row_scatter(self, g, idx, w, k):
            calls.append((idx.detach().clone(), k, g.shape[-1], g.dtype))
            return k1.row_scatter(g, idx, w, k)

    deterministic.k1 = Recording()
    try:
        fn()
    finally:
        deterministic.k1 = k1
    return calls


def e2e_lookup_ids(dev):
    """The ids of the e2e drive's bilinear lookups (the concat layout's map,
    neural_jacobian_field_torch.verify_e2e's configuration and synthetic
    scene, float32), recorded from one eager stage-1 update step of its
    first batch: (idx, k, c, dtype) of the first K1-bwd-rows call. The
    datasets draw their frame pairs from `random` and `np.random`, seeded
    first, as the drive seeds them."""
    import random
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from neural_jacobian_field_torch.config import (CONFIG_DIR, get_typed_root_config,
                                                    load_config)
    from neural_jacobian_field_torch.data import collate, get_dataset, make_synthetic_scene
    from neural_jacobian_field_torch.parallel import to_device
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, train_step
    from neural_jacobian_field_torch.verify_e2e import OVERRIDES

    random.seed(0)
    np.random.seed(0)
    with tempfile.TemporaryDirectory(prefix="njf_e2e_") as root:
        make_synthetic_scene(root, num_cameras=3, num_trajs=3, frames_per_traj=4, height=48,
                             width=64, action_dim=4)
        cfg = get_typed_root_config(load_config(CONFIG_DIR, [f"dataset.root={root}",
                                                             *OVERRIDES]))
        ds = get_dataset(replace(cfg.dataset, mode="perception"), "train")
        batch = to_device(collate([ds[i] for i in range(4)]), dev)
    model = new_model(dev, cfg.model, 0, dtype=None)
    state = create_train_state(model, TrainCfg(mode="perception", rays_per_batch=128,
                                               warm_up_steps=100, lr=5e-4))
    calls = record_row_scatter(lambda: train_step(
        state, batch, torch.Generator(device=dev).manual_seed(0), True))
    check(len(calls) > 0, "e2e: the step made no K1-bwd-rows call")
    return calls[0]


def recorded_row_ids(dev):
    """The ids K1-bwd-rows takes in one eager flagship stage-1 update step on
    the synthetic batch (train_batch, the step's own draws), recorded where
    gather_rows's backward calls it: {label: (idx [7, n, 1] on the card, k,
    c, dtype)} for the exact mode's fine and mid levels (the first call at
    each, one density's samples) and the epipolar knots' fine, mid and
    coarse levels; then the e2e drive's lookups (e2e_lookup_ids)."""
    import torch

    from neural_jacobian_field_torch.training import train_step

    out = {}
    fine, mid, coarse = (H // 2) * (W // 2), (H // 8) * (W // 8), (H // 16) * (W // 16)
    for mode, labels in (("exact", {fine: "exact fine", mid: "exact mid"}),
                         ("epipolar", {fine: "knots fine", mid: "knots mid",
                                       coarse: "knots coarse"})):
        model, state = new_train_state(dev, mode)
        calls = record_row_scatter(lambda: train_step(
            state, train_batch(dev), torch.Generator(device=dev).manual_seed(SEED + 3), True))
        torch.cuda.synchronize()
        for call in calls:
            label = labels.get(call[1])
            if label and label not in out:
                out[label] = call
        check(set(out) >= set(labels.values()), f"{mode}: K1-bwd-rows calls recorded at "
              f"{sorted({c[1] for c in calls})} rows, not the levels {sorted(labels)}")
        del model, state, calls
        gc.collect()
        torch.cuda.empty_cache()
    out["e2e lookups"] = e2e_lookup_ids(dev)
    return out


def mean_split(a, b):
    """The mean of two (device ms, {stage: ms}) readings of device_ms."""
    return (a[0] + b[0]) / 2, {name: (a[1][name] + b[1][name]) / 2 for name in a[1]}


def rows_line(label, gy, idx, w, k, lib_ms=None):
    """One K1-bwd-rows line: the kernel against its plain version on the
    card (1e-4 of scale: float32 sums reordered; for bf16 g beyond bf16's
    rounding of the sums) and, on every row whose entries it does not cut
    into pieces, bit for bit the plain version run on the CPU; two calls
    bit-identical; the ids' shape (entries per row and per texel block, rows
    cut, rows untouched); wrapper, device (per kernel), plain and library
    ms, the bound, and the previous design's device ms (per kernel) in this
    run, the two designs' device times each the mean of two readings taken
    in turns. -> the table row's record."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K

    b, n, c = gy.shape
    q, shared = idx.shape[-1], idx.shape[0] == 1 and b > 1
    got, again = K.row_scatter(gy, idx, w, k), K.row_scatter(gy, idx, w, k)
    rw = None if w is None else w.to(gy.dtype).float()
    want = K.row_scatter_plain(gy.float(), idx, rw, k)
    bf16 = gy.dtype == torch.bfloat16
    err, same = (rounded_err if bf16 else rel_err)(got, want), bool(torch.equal(got, again))
    plan = K.onehot_gather.rows_plan(b, n, k, c, torch.cuda.get_device_properties(
        gy.device).multi_processor_count, q, shared)
    counts = torch.bincount((idx.expand(b, -1, -1).reshape(b, -1) + k * torch.arange(
        b, device=idx.device)[:, None]).reshape(-1), minlength=b * k).view(b, k)
    whole = (counts <= plan.piece).cpu()
    cpu = K.row_scatter_plain(gy.cpu(), idx.cpu(), None if w is None else w.cpu(), k)
    bits = bool(torch.equal(got.cpu()[whole], cpu[whole]))
    tb = 1 << plan.log_tb
    blocks = torch.nn.functional.pad(counts, (0, plan.blocks * tb - k)).view(
        b, plan.blocks, tb).sum(-1).float()
    print(f"K1-bwd-rows {label}: {b}x{n}x{c} {str(gy.dtype)[6:]} onto {k} rows (Q {q}"
          f"{', weights' if w is not None else ''}{', one table' if shared else ''}): "
          f"max_abs_err {float((got.float() - want).abs().max()):.3e}, "
          f"{'beyond bf16 rounding ' if bf16 else ''}{err:.3e} of scale (tol 1e-4 of scale: "
          f"float32 sums reordered{', then rounded' if bf16 else ''}); bit "
          f"for bit the plain version on the CPU on the {int(whole.sum())} of {b * k} rows not "
          f"cut={bits}; two calls bit-identical={same}; entries per row max "
          f"{int(counts.max())}, {int((~whole).sum())} rows cut into pieces (> {plan.piece}), "
          f"untouched {float((counts == 0).float().mean()):.1%}; per block of {tb} rows max "
          f"{int(blocks.max())} mean {float(blocks.mean()):.1f}")
    check(got.dtype == gy.dtype and err <= 1e-4 and same and bits,
          f"K1-bwd-rows {label} disagrees with its plain version or does not repeat")
    row = Row()
    row.add(float((got.float() - want).abs().max()), cuda_time_ms(lambda: K.row_scatter(
        gy, idx, w, k)), cuda_time_ms(lambda: K.row_scatter_plain(gy, idx, w, k)),
        nbytes(gy, idx, got) + (0 if w is None else nbytes(w)), library_ms=lib_ms)
    # the two designs in turns (this, previous, previous, this): a call of a
    # few µs reads the card's state as much as the kernel's
    new, prev = ((lambda: K.row_scatter(gy, idx, w, k)), K1_BWD_ROWS_STAGES), (
        (lambda: K.onehot_gather.row_scatter_csr(gy, idx, w, k)), K1_BWD_STAGES)
    runs = [device_ms(fn, groups=groups) for fn, groups in (new, prev, prev, new)]
    d_ms, stages = mean_split(runs[0], runs[3])
    p_ms, p_stages = mean_split(runs[1], runs[2])
    rec = row.record()
    print("  stages (device ms per call): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in stages.items()) + f"; the previous design (K1-bwd's "
        f"counting sort, njf_row_scatter_csr): device {p_ms:.4f} (" + ", ".join(
            f"{name} {ms:.4f}" for name, ms in p_stages.items()) + ")")
    print_times("", row.ms, row.plain_ms, row.library_ms, extra=(
        f" (device {d_ms:.4f}, bound {rec['bound_ms']:.4f}, bound/device "
        f"{rec['bound_ms'] / d_ms:.1%}; device / previous design's {d_ms / p_ms:.1%})"))
    del got, again, want, cpu
    return rec


def row_scatter_checks(dev):
    """K1-bwd-rows, the fixed-order backward of the port's row gathers, on
    lines of its own (rows_line: against its plain version on the card and,
    on the rows it does not cut, bit for bit on the CPU; twice for identical
    bits; times beside its bound and the previous design's): the exact
    mode's fine level, 7 x 65,536 packed rows (4 x 128 bf16) onto 240x320
    with ids spread uniformly (the kernel table's row; the library call
    torch.gather's backward, scatter_add_ in bf16); then the ids one eager
    flagship update step gives it (recorded_row_ids), random g at each: the
    exact mode's fine and mid levels, the epipolar knots' fine, mid and
    coarse levels, and the e2e drive's bilinear lookups (float32, the
    concat layout's map; e2e_lookup_ids); the 2x upsampling of layer1 as
    Q = 4 corners with their weights on one table (7 images of 240x320 x
    64 bf16 onto 120x160; the route K1-bwd-upsample replaced); the
    interlevel loss's outer measure
    (float32, each of the 7 x 256 rays an image of 257 one-wide rows, 512
    sorted ids a ray; the route K1-bwd-small replaced). Then PyTorch's
    max_pool2d backward, which the step keeps, twice at the stem's shape and
    at the 2D UNet's, on tied inputs, for identical bits."""
    import torch

    from neural_jacobian_field_torch.ops.kernels.upsample_bwd import _upsample_corners

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    b, n, (hf, wf), c = TRAIN_B, TRAIN_RAYS * 256, (H // 2, W // 2), 512
    gy = torch.randn((b, n, c), generator=g, device=dev).to(torch.bfloat16)
    # rows spread over the map
    idx = (torch.rand((b, n, 1), generator=g, device=dev) * (hf - 1) * (wf - 1)).long()
    scatter = torch.zeros((b, hf * wf, c), dtype=torch.bfloat16, device=dev)
    ix = idx.expand(-1, -1, c)
    rec = rows_line("exact fine, uniform ids", gy, idx, None, hf * wf, cuda_time_ms(
        lambda: scatter.zero_().scatter_add_(1, ix, gy)))
    del gy, idx, scatter, ix
    for label, (idx, k, c, dtype) in recorded_row_ids(dev).items():
        gy = torch.randn((*idx.shape[:2], c), generator=g, device=dev).to(dtype)
        scatter = torch.zeros((idx.shape[0], k, c), dtype=dtype, device=dev)
        ix = idx.expand(-1, -1, c)
        rows_line(label + ", the step's ids", gy, idx, None, k, cuda_time_ms(
            lambda: scatter.zero_().scatter_add_(1, ix, gy)))
        del gy, idx, scatter, ix
        torch.cuda.empty_cache()
    # the 2x upsampling's backward (Q = 4, weighted, one table)
    hi, wi, c = H // 4, W // 4, 64
    gy = torch.randn((b, hf * wf, c), generator=g, device=dev).to(torch.bfloat16)
    ids, w = (t[None] for t in _upsample_corners(hi, wi, hf, wf, torch.bfloat16, dev))
    nchw = gy.reshape(b, hf, wf, c).permute(0, 3, 1, 2)
    rows_line("2x upsampling of layer1", gy, ids, w, hi * wi, cuda_time_ms(
        lambda: torch.ops.aten.upsample_bilinear2d_backward(nchw, [hf, wf], [b, c, hi, wi],
                                                            False)))
    del gy, ids, w, nchw
    # the interlevel loss's outer measure: cy1[lo] and cy1[hi + 1] per ray
    rays, s0, k = TRAIN_B * TRAIN_RAYS, 256, 257
    gy = torch.randn((rays, 2 * s0, 1), generator=g, device=dev)
    lo = torch.randint(0, k - 1, (rays, s0), generator=g, device=dev).sort(dim=1).values
    hi_ = torch.randint(1, k, (rays, s0), generator=g, device=dev).sort(dim=1).values
    idx = torch.cat([lo, hi_], dim=1)[..., None]
    flat = torch.zeros((rays, k, 1), device=dev)
    rows_line("interlevel loss", gy, idx, None, k, cuda_time_ms(
        lambda: flat.zero_().scatter_add_(1, idx, gy)))
    del gy, idx, flat
    max_pool_backward_checks(dev, g)
    return {"K1-bwd-rows": rec}


def fixed_order_checks(dev):
    """K1-bwd-upsample and K1-bwd-small, the fixed-order backwards that take
    the upsampling and the interlevel loss from K1-bwd-rows, each against
    its plain version run on the CPU (bit for bit: the kernels sum in the
    plain version's order) and twice for identical bits, with the wrapper,
    device and plain times, the library call's (upsample_bilinear2d_backward;
    scatter_add_) and that of the K1-bwd-rows route it replaces, in this
    run: the flagship's 2x upsampling of layer1 (7 x 240x320 x 64 bf16 onto
    120x160; the kernel table's row) and, on lines of their own, the concat
    layout's three onto the same 240x320 (64, 128 and 256 float32 channels
    from 2x, 4x and 8x smaller maps); the interlevel loss's per-ray rows
    (float32, 1,792 rays of 512 sorted ids onto 257 rows; the table's row),
    then the same rays with their ids shuffled (unsorted, hot rows)."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.ops.kernels.upsample_bwd import _upsample_corners

    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows = {}
    b, fine = TRAIN_B, (H // 2, W // 2)
    for label, (hi, wi), c, dtype in (
            ("flagship layer1 2x", (H // 4, W // 4), 64, torch.bfloat16),
            ("concat layer1 2x", (H // 4, W // 4), 64, torch.float32),
            ("concat layer2 4x", (H // 8, W // 8), 128, torch.float32),
            ("concat layer3 8x", (H // 16, W // 16), 256, torch.float32)):
        gy = torch.randn((b, *fine, c), generator=g, device=dev).to(dtype)
        got = K.upsample_bilinear_bwd(gy, (hi, wi))
        again = K.upsample_bilinear_bwd(gy, (hi, wi))
        want = K.upsample_bilinear_bwd_plain(gy.cpu(), (hi, wi))
        bits, same = bool(torch.equal(got.cpu(), want)), bool(torch.equal(got, again))
        err = float((got.cpu().float() - want.float()).abs().max())
        print(f"K1-bwd-upsample {label}: {b}x{fine[0]}x{fine[1]}x{c} {str(dtype)[6:]} onto "
              f"{hi}x{wi}: bit for bit the plain version on the CPU={bits} (max_abs_err "
              f"{err:.3e}; the kernel sums in its order); two calls bit-identical={same}")
        check(got.dtype == dtype and bits and same,
              f"K1-bwd-upsample {label} disagrees with its plain version or does not repeat")
        del again, want
        ids, w = (t[None] for t in _upsample_corners(hi, wi, *fine, dtype, dev))
        flat = gy.reshape(b, -1, c)
        nchw = gy.permute(0, 3, 1, 2)
        row = Row()
        row.add(err, cuda_time_ms(lambda: K.upsample_bilinear_bwd(gy, (hi, wi))),
                cuda_time_ms(lambda: K.upsample_bilinear_bwd_plain(gy, (hi, wi)), reps=3),
                nbytes(gy, got), library_ms=cuda_time_ms(
                    lambda: torch.ops.aten.upsample_bilinear2d_backward(
                        nchw, list(fine), [b, c, hi, wi], False)))
        d_ms = device_ms(lambda: K.upsample_bilinear_bwd(gy, (hi, wi)))
        route_ms = cuda_time_ms(lambda: K.row_scatter(flat, ids, w, hi * wi))
        route_d_ms = device_ms(lambda: K.row_scatter(flat, ids, w, hi * wi))
        rec = row.record()
        print_times("", row.ms, row.plain_ms, row.library_ms, extra=(
            f" (device {d_ms:.4f}, bound {rec['bound_ms']:.4f}, bound/device "
            f"{rec['bound_ms'] / d_ms:.1%}; the K1-bwd-rows route {route_ms:.4f}, device "
            f"{route_d_ms:.4f})"))
        if label.startswith("flagship"):
            rows["K1-bwd-upsample"] = rec
        del gy, got, ids, w, flat, nchw
        torch.cuda.empty_cache()
    # the interlevel loss's outer measure: cy1[lo] and cy1[hi + 1] per ray
    rays, s0, k = TRAIN_B * TRAIN_RAYS, 256, 257
    check(K.small_plan(2 * s0, k, 1) is not None, "the interlevel shape is not small_plan's")
    gy = torch.randn((rays, 2 * s0, 1), generator=g, device=dev)
    lo = torch.randint(0, k - 1, (rays, s0), generator=g, device=dev).sort(dim=1).values
    hi_ = torch.randint(1, k, (rays, s0), generator=g, device=dev).sort(dim=1).values
    idx = torch.cat([lo, hi_], dim=1)
    got = K.small_scatter(gy, idx, k)
    again = K.small_scatter(gy, idx, k)
    want = K.small_scatter_plain(gy.cpu(), idx.cpu(), k)
    bits, same = bool(torch.equal(got.cpu(), want)), bool(torch.equal(got, again))
    err = float((got.cpu() - want).abs().max())
    print(f"K1-bwd-small {rays}x{2 * s0}x1 onto {k} rows a ray (float32, the interlevel loss): "
          f"bit for bit the plain version on the CPU={bits} (max_abs_err {err:.3e}); two calls "
          f"bit-identical={same}")
    check(got.dtype == torch.float32 and bits and same,
          "K1-bwd-small disagrees with its plain version or does not repeat")
    flat = torch.zeros((rays, k, 1), device=dev)
    row = Row()
    row.add(err, cuda_time_ms(lambda: K.small_scatter(gy, idx, k)),
            cuda_time_ms(lambda: K.small_scatter_plain(gy, idx, k)), nbytes(gy, idx, got),
            library_ms=cuda_time_ms(lambda: flat.zero_().scatter_add_(1, idx[..., None], gy)))
    d_ms = device_ms(lambda: K.small_scatter(gy, idx, k))
    route_ms = cuda_time_ms(lambda: K.row_scatter(gy, idx[..., None], None, k))
    route_d_ms = device_ms(lambda: K.row_scatter(gy, idx[..., None], None, k))
    enqueue = host_ms(lambda: K.small_scatter(gy, idx, k))
    lib_enqueue = host_ms(lambda: flat.zero_().scatter_add_(1, idx[..., None], gy))
    rec = rows["K1-bwd-small"] = row.record()
    print_times("", row.ms, row.plain_ms, row.library_ms, extra=(
        f" (device {d_ms:.4f}, bound {rec['bound_ms']:.4f}, bound/device "
        f"{rec['bound_ms'] / d_ms:.1%}; host enqueue {enqueue:.4f} per call, the library "
        f"call's {lib_enqueue:.4f}; the K1-bwd-rows route {route_ms:.4f}, device "
        f"{route_d_ms:.4f})"))
    # the same rays with each ray's ids shuffled: unsorted, hot rows in runs
    perm = torch.argsort(torch.rand((rays, 2 * s0), generator=g, device=dev), dim=1)
    idx = torch.gather(idx, 1, perm)
    idx[:, : s0 // 2] = k // 2
    got = K.small_scatter(gy, idx, k)
    bits = bool(torch.equal(got.cpu(), K.small_scatter_plain(gy.cpu(), idx.cpu(), k)))
    print(f"K1-bwd-small, the ids shuffled and a quarter on one row: bit for bit the plain "
          f"version on the CPU={bits}")
    check(bits, "K1-bwd-small on unsorted ids disagrees with its plain version")
    return rows


def max_pool_backward_checks(dev, g):
    """PyTorch's max_pool2d backward, kept on the train steps: on tied
    inputs (three levels, so most windows hold ties) at the stem's shape
    (3x3 / 2, pad 1, [7, 240, 320, 64] bf16, channels last as the encoder
    passes it) and at the 2D UNet's first pool (2x2 / 2, [12, 252, 252, 32]
    float32), two backward calls bit-identical."""
    import torch
    import torch.nn.functional as F

    for label, shape, dtype, kw in (
            ("stem 3x3/2", (TRAIN_B, H // 2, W // 2, 64), torch.bfloat16,
             dict(kernel_size=3, stride=2, padding=1)),
            ("2d unet 2x2/2", (12, 252, 252, 32), torch.float32,
             dict(kernel_size=2, stride=2))):
        v = torch.randint(0, 3, shape, generator=g, device=dev).to(dtype)
        x = v.permute(0, 3, 1, 2).requires_grad_(True)
        y = F.max_pool2d(x, **kw)
        gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
        first, second = (torch.autograd.grad(y, x, gy, retain_graph=True)[0] for _ in range(2))
        same = bool(torch.equal(first, second))
        print(f"max_pool2d backward, {label} {list(shape)} {str(dtype)[6:]} on tied inputs: two "
              f"calls bit-identical={same}")
        check(same, f"max_pool2d's backward ({label}) differs between two calls")


def serving_weights(model, g):
    """Seeded weights for serving: the Jacobian head drawn so that J(x)
    varies over the scene at ~0.1 m per unit action (a fresh head is N(0,
    1e-4) everywhere: the same ~1e-4 constant at every point), and BatchNorm
    running statistics of a trained encoder, not the identity. The
    transformer's Dense head is drawn at a fiftieth of its kaiming scale:
    at a tenth, Adam's first 0.1 steps of the action carried composited
    points across the target camera's plane, and at a twenty-fifth the
    projection's curvature left the least-squares step close to its 2%
    bound, which holds the solve to the regime where the flow is close to
    linear in the action."""
    import numpy as np
    import torch

    from neural_jacobian_field_torch.models import initializers as init

    head = getattr(model.decoder, "jacobian_head", None)  # flow_mlp has none
    with torch.no_grad():
        if head is None:
            pass
        elif isinstance(head, torch.nn.Linear):  # the transformer's Dense head
            init.kaiming_normal_in_(head.weight, g)
            head.weight.mul_(0.02)
            head.bias.zero_()
        else:  # a ResnetFC at the density head's scale, its output layer shrunk
            head.near_zero_init = False
            head.init_weights(g)
            head.lin_out.weight.mul_(0.01)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return model


def build_model(dev, mode, cfg=None, dtype="bfloat16"):
    """The flagship model in this feature mode (or the model of `cfg`, in
    float32 where dtype is None) with seeded serving weights, in eval mode
    on the card."""
    import torch

    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg

    g = torch.Generator().manual_seed(SEED)
    model = Model(cfg or flagship_model_cfg(pixel_feature_mode=mode),
                  compute_dtype=dtype and getattr(torch, dtype)).init_weights(g)
    return serving_weights(model, g).to(dev).eval()


def cameras(dev, seed=SEED, degrees=10.0):
    import numpy as np
    import torch

    from neural_jacobian_field_torch.models.model import CameraInput, RobotInput

    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.uniform(size=(1, H, W, 3)).astype(np.float32))
    intr = torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.6, 0.5], [0.0, 0.0, 1.0]]])
    # target camera: 10 degrees about the y axis through a focus point 2 m in
    # front of the context camera, so every epipolar segment has length
    t = math.radians(degrees)
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


def same_bits(got, want) -> bool:
    """Every tensor of got equal to want's, bit for bit."""
    import torch

    return len(got) == len(want) and all(g.shape == w.shape and bool(torch.equal(g, w))
                                         for g, w in zip(got, want))


def outputs_of(x) -> tuple:
    """The tensors of an entry point's result (a dataclass or a tuple)."""
    import torch

    values = vars(x).values() if dataclasses.is_dataclass(x) else x
    return tuple(v for v in values if isinstance(v, torch.Tensor))


def captured_vs_eager(label, model, fn, reps=3, timer=None):
    """fn() through its captured programs against fn() inside
    model.programs.eager(): the eager time, the first captured call (it
    captures), the captured time, and bit-for-bit agreement of the outputs
    and of two replays. Timed on the host clock around a synchronised call
    (median of reps), or by `timer`. Returns (captured outputs, times)."""
    import torch

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    timer = timer or (lambda: statistics.median(wall_ms()[0] for _ in range(reps)))
    with model.programs.eager():
        fn()  # warm-up: allocator, handles
        eager_ms = timer()
        want = outputs_of(fn())
    capture_ms, _ = wall_ms()
    captured_ms = timer()
    got, again = outputs_of(fn()), outputs_of(fn())
    same, repeat = same_bits(got, want), same_bits(again, got)
    print(f"{label}: eager {eager_ms:.3f} ms, captured {captured_ms:.3f} ms "
          f"(eager/captured {eager_ms / captured_ms:.2f}x; first call with the capture "
          f"{capture_ms:.1f} ms); captured == eager bit for bit: {same}; two replays "
          f"bit-identical: {repeat}")
    check(same and repeat, f"{label}: the captured program disagrees with eager execution "
                           f"or does not repeat")
    return got, dict(eager_ms=eager_ms, captured_ms=captured_ms, capture_ms=capture_ms)


def follows(label, model, fn):
    """fn() replayed on new inputs or weights equals fn() run eagerly."""
    got = outputs_of(fn())
    with model.programs.eager():
        want = outputs_of(fn())
    same = same_bits(got, want)
    print(f"{label}: captured == eager bit for bit: {same}")
    check(same, f"{label}: a replay did not follow its new inputs")


def sweep_program(model, cam, robot):
    """The whole 480x640 render as ONE captured program (every chunk in one
    graph, as JAX's lax.map sweeps them in one jit), reading the encoder
    program's outputs in place. Returns a function that renders through it."""
    import torch

    from neural_jacobian_field_torch.inference.programs import CapturedProgram
    from neural_jacobian_field_torch.inference.render import _render_chunk, camera_rays
    from neural_jacobian_field_torch.ops.pixel_gather import features_from_fields

    image = cam.input_image
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    near = torch.full((1,), Z_NEAR, device=image.device)
    far = torch.full((1,), Z_FAR, device=image.device)
    encoder = model.features_program(image)
    features = features_from_fields(encoder.replay(image))

    def sweep(*xs):
        *per_render, o, d = xs
        outs = None
        for s in range(0, H * W, PATCH):
            part = _render_chunk(model, features, *per_render, o[:, s:s + PATCH],
                                 d[:, s:s + PATCH])
            if outs is None:
                outs = [p.new_empty((1, H * W, *p.shape[2:])) for p in part]
            for out, p in zip(outs, part):
                out[:, s:s + PATCH].copy_(p)
        return tuple(outs)

    inputs = (cam.ctxt_extrinsics, cam.ctxt_intrinsics, cam.trgt_extrinsics,
              cam.trgt_intrinsics, robot.robot_action, near, far, origins, dirs)
    with torch.no_grad():  # as patch_render captures its chunk program
        program = CapturedProgram(sweep, inputs, model.programs.backend)

    def render():
        encoder.replay(image)
        return tuple(o.reshape(1, H, W, *o.shape[2:]) for o in program(*inputs))

    return render


def render_vs_eager(dev, model, label, render, want_counts, af_width, timings, tag,
                    hw=None):
    """render() eager (launch counters reset just before, read just after),
    then captured: the first call captures the chunk program, the main-path
    run after it is counted through replay, a third repeats it. Checks: the
    captured outputs equal the eager ones bit for bit and repeat, both runs'
    launches equal want_counts, no legacy kernel ran, the outputs are finite
    and of their shapes (action features af_width wide). Returns the
    captured outputs and launches."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K

    h, w = hw or (H, W)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with model.programs.eager():
        K.reset_launch_counts()
        t0 = time.perf_counter()
        want = render()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager_launches = K.launch_counts()
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = K.launch_counts()
    check_no_legacy(f"{label} serving")
    t0 = time.perf_counter()
    again = render()
    torch.cuda.synchronize()
    render2_s = time.perf_counter() - t0
    timings[tag + "eager_render_s"] = eager_s
    timings[tag + "render_s"] = render_s
    timings[tag + "render_rays_per_s"] = h * w / render_s
    timings[tag + "render_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    timings[tag + "eager_render_peak_mem_gib"] = eager_peak
    same, repeat = (same_bits(outputs_of(out), outputs_of(want)),
                    same_bits(outputs_of(again), outputs_of(out)))
    print(f"render {label} {h}x{w}: captured {render_s:.3f} s and {render2_s:.3f} s "
          f"({h * w / render_s:.1f} rays/s), eager {eager_s:.3f} s ({h * w / eager_s:.1f} "
          f"rays/s; eager/captured {eager_s / render_s:.2f}x), first captured call "
          f"{capture_s:.3f} s; peak {timings[tag + 'render_peak_mem_gib']:.2f} GiB captured "
          f"(the programs' pools), {eager_peak:.2f} GiB eager; captured == eager bit for "
          f"bit: {same}; two replays bit-identical: {repeat}; launches {launches}")
    check(same and repeat, f"{label} render: captured disagrees with eager or does not repeat")

    for name, shape in (("rgb", (1, h, w, 3)), ("depth_raw", (1, h, w, 1)),
                        ("flow_raw", (1, h, w, 2)), ("action_features", (1, h, w, af_width))):
        t = getattr(out, name)
        check(tuple(t.shape) == shape, f"{label} {name} shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), f"{label} {name} has non-finite values")
    print(f"{label} rgb range [{float(out.rgb.min()):.4f}, {float(out.rgb.max()):.4f}], depth "
          f"range [{float(out.depth_raw.min()):.4f}, {float(out.depth_raw.max()):.4f}], "
          f"|flow| max {float(out.flow_raw.abs().max()):.4e}")
    check(launches == want_counts and eager_launches == want_counts,
          f"{label} serving launches {launches} (eager {eager_launches}) != {want_counts}")
    return out, launches


def serve_phase(dev, model, cam, robot, timings, mode):
    import torch

    from neural_jacobian_field_torch.inference.render import camera_rays, render_camera
    from neural_jacobian_field_torch.models.model import RenderingInput
    from neural_jacobian_field_torch.ops.pixel_gather import feature_fields

    tag = "" if mode == "epipolar" else "exact_"

    def encode():
        with torch.no_grad():
            return feature_fields(model.compute_pixel_encoding(cam, robot).features)[:3]

    def render(c=cam, r=robot):
        return render_camera(model, c, r, Z_NEAR, Z_FAR, H, W, patch_size=PATCH)

    # the encoder: eager, then its captured program (CUDA events, median of 5)
    _, t = captured_vs_eager(f"encode {mode} (24 K9 + 2 K6)", model, encode,
                             timer=lambda: cuda_time_ms(encode, reps=5, warmup=1))
    timings[tag + "eager_encode_ms"], timings[tag + "encode_ms"] = t["eager_ms"], t["captured_ms"]

    n = H * W // PATCH
    if mode == "epipolar":  # K6 packs the coarse level per chunk for the knots
        want_counts = all_zero_but({"K9-fwd": 24, "K6-fwd": 2 + n, "K5": n,
                                    "K7-tz-fwd": 3 * n})
    else:
        want_counts = all_zero_but({"K9-fwd": 24, "K6-fwd": 2, "K5": n, "K7-fwd": 3 * n,
                                    "K1-fwd": 2 * n})
    out, launches = render_vs_eager(dev, model, mode, render, want_counts, 24, timings, tag)

    # the whole sweep as one graph, against the chunk program's replays
    t0 = time.perf_counter()
    sweep = sweep_program(model, cam, robot)
    sweep()
    torch.cuda.synchronize()
    sweep_capture_s = time.perf_counter() - t0
    sweep_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swept = sweep()
        torch.cuda.synchronize()
        sweep_times.append(time.perf_counter() - t0)
        chunked_t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        sweep_times.append(time.perf_counter() - chunked_t0)
    timings[tag + "sweep_render_s"] = min(sweep_times[0::2])
    same = same_bits(swept, outputs_of(out))
    print(f"render {mode} as one graph of {n} chunks: {sweep_times[0]:.3f} / "
          f"{sweep_times[2]:.3f} s against the chunk program's {sweep_times[1]:.3f} / "
          f"{sweep_times[3]:.3f} s (alternating, same call); capture {sweep_capture_s:.1f} s; "
          f"== the chunk program's bit for bit: {same}")
    check(same, f"{mode}: the one-graph render disagrees with the chunk program's")
    del sweep, swept
    gc.collect()
    torch.cuda.empty_cache()

    # replays follow new inputs (a new image, the target camera moved to 14
    # degrees, a new action) and weights loaded in place (the same programs)
    # or reassigned (captured again)
    cam2, robot2 = cameras(dev, seed=SEED + 1, degrees=14.0)
    follows(f"render {mode}, new image, camera and action", model,
            lambda: render(cam2, robot2))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    perturbed = {k: v * 1.05 if v.is_floating_point() else v for k, v in state.items()}
    programs = list(model.programs)
    model.load_state_dict(perturbed)
    follows(f"render {mode}, weights loaded in place", model, render)
    check(list(model.programs) == programs,
          "weights loaded in place changed the programs")
    model.load_state_dict({k: v.clone() for k, v in perturbed.items()}, assign=True)
    follows(f"render {mode}, weights reassigned", model, render)
    check(not any(p in programs for p in model.programs),
          "reassigned weights did not capture the programs again")
    model.load_state_dict(state)

    # one chunk again, stage by stage, kernels vs plain versions. A random
    # field at bf16 is chaotic end to end (a 1e-4 m shift of a sample moves
    # its 2^9 NeRF frequency by ~0.3 rad), so each stage gets the SAME inputs
    # in both runs (the kernel run's) and is compared on its own output.
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    lo = (n // 2) * PATCH
    ri = RenderingInput(origins=origins[:, lo:lo + PATCH], directions=dirs[:, lo:lo + PATCH],
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    with torch.no_grad(), model.programs.eager():
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


def inverse_dynamics_phase(dev, model, cam, robot, timings, mode, tag=None):
    import torch

    from neural_jacobian_field_torch.inference.action_opt import (
        optimize_actions, solve_actions_least_squares)
    from neural_jacobian_field_torch.inference.render import camera_rays
    from neural_jacobian_field_torch.models.model import (
        ModelInferenceEncoding, RenderingInput, RobotInput)

    if tag is None:
        tag = "" if mode == "epipolar" else "exact_"
    g = torch.Generator(device=dev).manual_seed(SEED)
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    pick = torch.randperm(H * W, generator=g, device=dev)[:ID_RAYS]
    ri = RenderingInput(origins=origins[:, pick], directions=dirs[:, pick],
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    got, t = captured_vs_eager(f"encode_image {mode} ({ID_RAYS} rays)", model,
                               lambda: model.encode_image(cam, ri, robot))
    enc = ModelInferenceEncoding(*got)
    timings[tag + "eager_id_encode_ms"], timings[tag + "id_encode_ms"] = (t["eager_ms"],
                                                                          t["captured_ms"])
    # a small action keeps the target in the regime where the flow is close
    # to linear in the action (the least-squares step linearises at a = 0;
    # at 5x this action the projection's curvature alone leaves ~6%)
    a_star = 0.02 * torch.randn((1, 8), generator=g, device=dev)
    with torch.no_grad():
        target = model.infer_optical_flow(enc, cam, RobotInput(a_star))
    action0 = 1e-3 * torch.randn((1, 8), generator=g, device=dev)
    res, t = captured_vs_eager(
        f"inverse dynamics {mode}, 100 Adam steps", model,
        lambda: optimize_actions(model, enc, cam, target, action0=action0, num_iters=100))
    timings[tag + "eager_inverse_dynamics_ms"] = t["eager_ms"]
    timings[tag + "inverse_dynamics_ms"] = t["captured_ms"]
    losses, best_loss = res[2], res[1]
    l0, lbest = float(losses[0]), float(best_loss)
    print(f"inverse dynamics {mode} ({ID_RAYS} rays): loss {l0:.4e} -> {lbest:.4e} "
          f"(bound: best < 0.5 x initial)")
    check(math.isfinite(lbest) and lbest < 0.5 * l0, "inverse dynamics loss did not fall")
    (a,), t = captured_vs_eager(f"least squares {mode}", model,
                                lambda: (solve_actions_least_squares(model, enc, cam, target),))
    timings[tag + "eager_least_squares_ms"] = t["eager_ms"]
    timings[tag + "least_squares_ms"] = t["captured_ms"]
    with torch.no_grad():
        flow = model.infer_optical_flow(enc, cam, RobotInput(a))
    resid = float(torch.linalg.norm(flow - target) / torch.linalg.norm(target))
    print(f"least squares {mode}: relative flow residual {resid:.3e} (bound 2e-2), "
          f"|a - a*| {float((a - a_star).abs().max()):.3e}")
    check(resid < 2e-2, "least-squares residual above its bound")
    # the solvers' replays follow a new target flow and a new action0
    with torch.no_grad():
        target2 = model.infer_optical_flow(enc, cam, RobotInput(-0.5 * a_star))
    follows(f"inverse dynamics {mode}, new target and action0", model,
            lambda: optimize_actions(model, enc, cam, target2, action0=-action0, num_iters=100))
    follows(f"least squares {mode}, new target", model,
            lambda: (solve_actions_least_squares(model, enc, cam, target2),))


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
    out = model(mi, train=True, ctx=StepCtx(anneal=1.0, updated=updated, draws=draws,
                                            render_flow=cfg.mode == "action"))
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


def new_model(dev, cfg, seed, dtype="bfloat16", remat=False):
    """Model(cfg) with seeded weights on the card, computing in `dtype`
    (float32 where it is None)."""
    import torch

    from neural_jacobian_field_torch.models.model import Model

    model = Model(cfg, compute_dtype=dtype and getattr(torch, dtype), remat=remat)
    return model.init_weights(torch.Generator().manual_seed(seed)).to(dev)


def new_train_state(dev, mode, conv_impl="pallas", variant=None):
    """The flagship model (or the phase-10 variant's) with seeded weights and
    its stage-1 train state."""
    from neural_jacobian_field_torch.models.model import flagship_model_cfg
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = (variant.model(dev, SEED) if variant else
             new_model(dev, flagship_model_cfg(conv_impl=conv_impl, pixel_feature_mode=mode),
                       SEED))
    cfg = TrainCfg(lr=TRAIN_LR, warm_up_steps=TRAIN_WARMUP, rays_per_batch=TRAIN_RAYS)
    return model, create_train_state(model, cfg)


def train_setup(dev, mode, conv_impl="pallas", variant=None):
    """The flagship model (or the phase-10 variant's) with seeded weights,
    its train state, a batch and a generator, warmed up on both gates
    (allocator, cuBLAS)."""
    import torch

    from neural_jacobian_field_torch.training import train_step

    model, state = new_train_state(dev, mode, conv_impl, variant)
    batch = train_batch(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for updated in (True, True, False, False):
        train_step(state, batch, g, updated)
    torch.cuda.synchronize()
    return model, state, batch, g


def to_cpu(x):
    """A copy of x with every tensor in it on the host."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    return x


def snapshot(state) -> dict:
    """The train state on the host: weights, BatchNorm statistics, Adam's
    state and the host's counters."""
    return dict(model=to_cpu(state.model.state_dict()),
                opt=to_cpu(state.optimizer.state_dict()),
                counters=(state.step, state.steps_since_update))


def restore(state, snap) -> None:
    """Load a snapshot into the state in place."""
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["opt"])
    state.step, state.steps_since_update = snap["counters"]


def state_record(state):
    """(names, host copies) of what a train step updates: the parameters,
    the BatchNorm statistics, Adam's count and moments."""
    opt = state.optimizer
    named = [(n, p.detach()) for n, p in state.model.named_parameters()]
    named += list(state.model.named_buffers())
    pname = {id(p): n for n, p in state.model.named_parameters()}
    count, *moments = opt.state_tensors()
    named.append(("adam count", count))
    named += [(f"adam {k} {pname[id(p)]}", t) for (p, k), t in zip(
        ((p, k) for p in opt.params() for k in ("exp_avg", "exp_avg_sq")), moments)]
    return [n for n, _ in named], [t.cpu().clone() for _, t in named]


def run_steps(state, batch, plan):
    """The plan's steps, [(gate, yx, draws)], through make_train_step (CUDA
    graphs, unless inside model.programs.eager()); returns (names, host
    copies) of each step's metrics, then of `state_record`."""
    import torch

    from neural_jacobian_field_torch.training import make_train_step

    names, out = [], []
    for i, (gate, yx, draws) in enumerate(plan):
        metrics = make_train_step(state.model, state.cfg, static_updated=gate)(
            state, batch, yx=yx, draws=draws)
        names += [f"step {i} {k}" for k in metrics]
        out += [v.cpu() for v in metrics.values()]
    torch.cuda.synchronize()
    rec_names, rec = state_record(state)
    return names + rec_names, out + rec


# aten ops that CUDA implements with atomic adds, so that their sums come in
# another order from run to run (cuDNN's convolution_backward unless cuDNN
# is held to its deterministic algorithms; index_put only when it
# accumulates). max_pool2d's backward gathers (max_pool_backward_checks).
ATOMIC_OPS = ("scatter_add", "index_add", "index_put", "_index_put_impl", "put",
              "upsample_bilinear2d_backward", "grid_sampler_2d_backward",
              "embedding_dense_backward", "convolution_backward")


def ops_with_atomics(fn) -> list:
    """The ATOMIC_OPS that fn() runs, forward and backward (a dispatch mode
    that records every aten op; convolution_backward where cuDNN was not
    held to deterministic algorithms as it ran, index_put where it
    accumulated)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__.rstrip("_")
            kwargs = kwargs or {}
            if name == "convolution_backward" and torch.backends.cudnn.deterministic:
                pass
            elif name in ("index_put", "_index_put_impl") and not (
                    kwargs.get("accumulate", len(args) > 3 and args[3])):
                pass
            else:
                seen.add(name)
            return func(*args, **kwargs)

    with Record():
        fn()
    return sorted(seen & {op.rstrip("_") for op in ATOMIC_OPS})


def warned_ops(fn) -> list:
    """The ops that warn, under torch.use_deterministic_algorithms(True,
    warn_only=True), that they have no deterministic implementation while
    fn() runs (each warning's text up to its first comma or period)."""
    import warnings

    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    return sorted({re.split(r"[,.]", str(w.message), maxsplit=1)[0][:120] for w in caught
                   if "determinis" in str(w.message)})


def determinism_report(dev, runs=3, torch_deterministic=False):
    """`--determinism`: for phase 5's stage-1 steps (epipolar, exact,
    pallas_fused) and phase 10's transformer model and JAX defaults
    (float32), the three steps of the
    captured-vs-eager check run eagerly: the ops that warn under
    torch.use_deterministic_algorithms(True, warn_only=True), the ops with
    atomic sums that a step runs (ops_with_atomics), the tensors in which
    `runs` eager runs differ; then the 5-frozen + 1-update cycle's rays/s,
    as six replays and as one 6-step program (captured_step_times).
    Returns the paths whose eager runs differ or that run an atomic sum.
    torch_deterministic: everything under
    torch.use_deterministic_algorithms(True) (PyTorch's own deterministic
    forms of those ops, a process-wide flag; its default of filling new
    memory kept), where a path fails only if its eager runs differ or its
    programs cannot be captured (the atomic ops are named, not counted)."""
    import torch

    if torch_deterministic:
        torch.use_deterministic_algorithms(True)
        print("determinism: under torch.use_deterministic_algorithms(True), "
              f"fill_uninitialized_memory="
              f"{torch.utils.deterministic.fill_uninitialized_memory}")

    from neural_jacobian_field_torch.models.model import make_model_cfg
    from neural_jacobian_field_torch.training import step_randomness

    cases = [("train epipolar", "epipolar", "pallas", None),
             ("train exact", "exact", "pallas", None),
             ("train fused", "epipolar", "pallas_fused", None),
             ("transformer train", "epipolar", "pallas",
              Variant("transformer", yaml_model_cfg(*TRANSFORMER_OVERRIDES))),
             ("defaults train", "exact", "pallas",
              Variant("defaults", make_model_cfg(), dtype=None))]
    failed, timings = [], {}
    for label, mode, conv_impl, variant in cases:
        model, state, batch, g = train_setup(dev, mode, conv_impl, variant)
        plan = [(u, *step_randomness(state, batch, g)) for u in (True, False, False)]
        snap = snapshot(state)
        with state.model.programs.eager():
            warned = warned_ops(lambda: run_steps(state, batch, plan))
            restore(state, snap)
            ops = ops_with_atomics(lambda: run_steps(state, batch, plan[:1]))
            restore(state, snap)
        names, eager, _ = eager_runs(state, batch, plan, runs)
        differ = [n for i, n in enumerate(names)
                  if not all(torch.equal(eager[0][i], r[i]) for r in eager[1:])]
        print(f"determinism {label}: ops that warn under use_deterministic_algorithms: "
              f"{warned or 'none'}; ops with atomic sums on a step: {ops or 'none'}; "
              f"{runs} eager runs of 3 steps differ in {len(differ)} of {len(names)} tensors "
              f"{differ[:4]}")
        if differ or (ops and not torch_deterministic):
            failed.append(label)
        try:
            captured_step_times(dev, state, batch, g, f"determinism {label}",
                                label.replace(" ", "_") + "_", timings)
        except Exception as e:  # a capture the flag's ops refuse
            print(f"determinism {label}: capture failed: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:200]}")
            failed.append(label)
        del model, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    print("determinism cycle rays/s: " + json.dumps(
        {k: round(v, 1) for k, v in timings.items() if k.endswith("cycle_rays_per_s")}))
    return failed


def eager_runs(state, batch, plan, runs=5):
    """The plan's steps eagerly, `runs` times from the state as it is; the
    state is left as it was. Returns (names, the runs' host copies, the ops
    with atomic sums that the plan's first step runs)."""
    snap = snapshot(state)
    out = []
    with state.model.programs.eager():
        for _ in range(runs):
            names, record = run_steps(state, batch, plan)
            out.append(record)
            restore(state, snap)
        ops = ops_with_atomics(lambda: run_steps(state, batch, plan[:1]))
        restore(state, snap)
    return names, out, ops


def compare_captured(label, names, eager, captured, ops, exact=False):
    """Captured against the eager runs, tensor by tensor: equal bit for bit
    where the eager runs all are. `exact` (the stage-1 steps, which sum in
    a fixed order, as JAX's step does): the eager runs must also be
    bit-identical in every tensor and no op on the step may sum with
    atomics, so that captured == eager bit for bit everywhere. Elsewhere a step's sums come in another
    order from run to run, and the captured run is one more such run: per
    tensor, its l2 distance to the nearest eager run over the eager runs'
    largest distance from each other is at most 10, and the median of that
    ratio over those tensors at most 1 (exchangeable runs give ratios well
    under 1; a run that computes something else gives ratios above 1 in most
    tensors). The differing tensors and the ops with atomic sums on a step
    are named."""
    import itertools

    import torch

    def l2(x, y):
        return float((x.double() - y.double()).norm())

    bad, ratios, repeat, equal = [], {}, 0, 0
    for i, name in enumerate(names):
        runs, c = [run[i] for run in eager], captured[i]
        same = all(torch.equal(runs[0], r) for r in runs[1:])
        repeat += same
        equal += torch.equal(runs[0], c)
        if not bool(torch.isfinite(c.float()).all()) or (same and not torch.equal(runs[0], c)):
            bad.append(name)
        elif not same:
            spread = max(l2(x, y) for x, y in itertools.combinations(runs, 2))
            ratios[name] = min(l2(c, x) for x in runs) / spread
    worst = max(ratios, key=ratios.get, default="-")
    median = statistics.median(ratios.values()) if ratios else 0.0
    bad += [n for n, r in ratios.items() if r > 10.0]
    steps = len({n.split()[1] for n in names if n.startswith("step ")})
    print(f"{label} captured vs eager, {steps} step{'s' if steps > 1 else ''} from one state: "
          f"{len(names)} tensors; "
          f"{len(eager)} eager runs bit-identical in {repeat}, captured == eager bit for bit in "
          f"{equal} (required where the eager runs are); eager differs from itself in "
          f"{len(ratios)} {list(ratios)[:3]}: captured's l2 distance to the nearest eager run "
          f"over the eager runs' spread, median {median:.3f} (bound 1), largest "
          f"{ratios.get(worst, 0.0):.3f} at {worst} (bound 10); ops with atomic sums on a step: "
          f"{ops or 'none'}")
    check(not bad and median <= 1.0,
          f"{label}: captured steps disagree with eager at {bad[:6]} (median ratio {median:.3f})")
    if exact:
        check(repeat == len(names) and not ops,
              f"{label}: a stage-1 step does not repeat: eager runs differ in "
              f"{len(names) - repeat} tensors {list(ratios)[:4]}, ops with atomic sums {ops}")


def peak_window(dev):
    """Start a window for peak memory: the allocator's unused cache released,
    the peaks reset."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def peaks_gib(dev):
    """(allocated, reserved) peaks of the window, GiB."""
    import torch

    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            torch.cuda.max_memory_reserved(dev) / 2 ** 30)


def captured_step_times(dev, state, batch, g, label, tag, timings):
    """Replays of the update and frozen programs, the 5-frozen + 1-update
    cycle as six replays and as one 6-step program (captured first); host
    clock around synchronised calls. Returns the stacked batch and the
    peak memory of the replays, (allocated, reserved) GiB: the programs'
    pool, the resident state and the static buffers."""
    import torch

    from neural_jacobian_field_torch.training import (
        make_multi_train_step, make_train_step, stack_batches)

    model, cfg = state.model, state.cfg
    steps = {u: make_train_step(model, cfg, static_updated=u) for u in (True, False)}
    gates = (False,) * 5 + (True,)
    multi = make_multi_train_step(model, cfg, 6, static_schedule=gates)
    stacked = stack_batches([batch] * 6)
    t0 = time.perf_counter()
    multi(state, stacked, generator=g)  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak_window(dev)
    times = {True: [], False: []}
    for updated in (False,) * 5 + (True,) + (False,) * 5 + (True,) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[updated](state, batch, generator=g)
        torch.cuda.synchronize()
        times[updated].append((time.perf_counter() - t0) * 1e3)
    six = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for updated in gates:
            steps[updated](state, batch, generator=g)
        torch.cuda.synchronize()
        six.append(time.perf_counter() - t0)
    one = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, stacked, generator=g)
        torch.cuda.synchronize()
        one.append(time.perf_counter() - t0)
    upd, frz = statistics.median(times[True]), statistics.median(times[False])
    rays = 6 * TRAIN_B * TRAIN_RAYS
    timings[tag + "captured_update_step_ms"] = upd
    timings[tag + "captured_frozen_step_ms"] = frz
    timings[tag + "captured_cycle_rays_per_s"] = rays / statistics.median(six)
    timings[tag + "program6_cycle_rays_per_s"] = rays / statistics.median(one)
    print(f"{label} captured step: update {upd:.2f} ms, frozen {frz:.2f} ms (medians of "
          f"{len(times[True])} / {len(times[False])} replays); 5 frozen + 1 update cycle as six "
          f"replays {statistics.median(six) * 1e3:.2f} ms = "
          f"{timings[tag + 'captured_cycle_rays_per_s']:.1f} rays/s, as one 6-step program "
          f"{statistics.median(one) * 1e3:.2f} ms = "
          f"{timings[tag + 'program6_cycle_rays_per_s']:.1f} rays/s (medians of 3; the "
          f"6-step program captured in {capture_s:.2f} s); {card_line()}")
    return stacked, peaks_gib(dev)


def dispatch_run(state, stacked, g, label):
    """30 steps in 6-step windows through MultiStepDispatch, its warm-up the
    first window: the warm-up window and a tuple's first sight take the
    default (each substep replays its gate's one-step program), a recurring
    tuple its own 6-step program. Returns the losses."""
    from neural_jacobian_field_torch.training import (
        MultiStepDispatch, host_step_schedule, make_multi_train_step)

    model, cfg = state.model, state.cfg
    dispatch = MultiStepDispatch(
        lambda gt: make_multi_train_step(model, cfg, 6, static_schedule=gt),
        warmup=state.step + 6)
    default = make_multi_train_step(model, cfg, 6)
    picks, losses = [], []
    for _ in range(5):
        gates, ssu = [], state.steps_since_update
        for j in range(6):
            updated, ssu = host_step_schedule(state.step + j, ssu, model.cfg.rendering)
            gates.append(updated)
        fn = dispatch.select(state.step, gates, default)
        picks.append(("default" if fn is default else "program")
                     + "".join("U" if u else "F" for u in gates))
        losses += [float(v) for v in fn(state, stacked, generator=g)["loss/total"]]
    print(f"{label} MultiStepDispatch, 30 steps in windows of 6 past a 6-step warm-up: "
          f"{picks}; {len(dispatch._programs)} gate tuple programs; losses finite "
          f"{all(math.isfinite(v) for v in losses)}")
    check(picks[-1].startswith("program") and all(math.isfinite(v) for v in losses),
          f"{label}: MultiStepDispatch did not reach a program, or a loss is not finite")


def stage1_counts(mode, conv="K9-fwd", trunks=True):
    """Launches per stage-1 update and frozen step: the 24 stride-1 convs
    forward (`conv`: K9-fwd or K10; None where cuDNN runs them) and their
    K9-dgrad and K9-wgrad, K5, the packing (K6) and in exact mode the
    coarse-level gathers (K1), and, where the trunks are fused (`trunks`),
    two trunks forward: the proposal and NeRF densities (no flow is rendered
    in stage 1, so no Jacobian trunk or transformer runs); the backward of
    both on an update step, of the NeRF density alone on a frozen one.
    K1-bwd-rows, the fixed-order backward of the packed-row gathers (the
    three knot levels once per step in epipolar mode; fine and mid per
    density in exact mode); K1-bwd-upsample, of layer1's upsampling to the
    fine level; on an update step K1-bwd-small, of the interlevel loss's
    per-ray gather."""
    want = {}
    for kind, n_bwd in (("update", 2), ("frozen", 1)):
        c = {"K5": 1}
        if conv:
            c.update({conv: 24, "K9-dgrad": 24, "K9-wgrad": 24})
        c.update({"K1-bwd-upsample": 1, "K1-bwd-small": int(kind == "update")})
        if mode == "epipolar":
            c.update({"K6-fwd": 3, "K6-bwd": 3, "K1-bwd-rows": 3})
            if trunks:
                c.update({"K7-tz-fwd": 2, "K7-tz-bwd": n_bwd})
        else:
            c.update({"K6-fwd": 2, "K6-bwd": 2, "K1-fwd": 2, "K1-bwd": n_bwd,
                      "K1-bwd-rows": 2 * n_bwd})
            if trunks:
                c.update({"K7-fwd": 2, "K7-bwd": n_bwd})
        want[kind] = all_zero_but(c)
    return want


def gate_counts(state, batch, g, label, want):
    """The launch counts of one eager frozen and one eager update step
    (counters reset before each), each equal to want[kind], no legacy
    kernel. Returns {kind: counts}."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.training import train_step

    counts = {}
    for kind, updated in (("frozen", False), ("update", True)):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        train_step(state, batch, g, updated)
        torch.cuda.synchronize()
        counts[kind] = K.launch_counts()
        check_no_legacy(f"{label} {kind} step")
        print(f"{label} launches per {kind} step: {counts[kind]}")
        check(counts[kind] == want[kind],
              f"{label} {kind} step launches {counts[kind]} != {want[kind]}")
    return counts


def replay_counts(state, batch, g, label, want):
    """As gate_counts, through the captured programs of both gates (counted
    through replay: each program is called once first, so a capture's
    warm-up calls are not counted). Returns {"<kind> captured": counts}."""
    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.training import make_train_step

    counts = {}
    for kind, updated in (("frozen", False), ("update", True)):
        step = make_train_step(state.model, state.cfg, static_updated=updated)
        step(state, batch, generator=g)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        step(state, batch, generator=g)
        torch.cuda.synchronize()
        got = counts[kind + " captured"] = K.launch_counts()
        check_no_legacy(f"{label} captured {kind} step")
        print(f"{label} launches per captured {kind} step (counted through replay): {got}")
        check(got == want[kind], f"{label} captured {kind} step launches {got} != {want[kind]}")
    return counts


def train_phase(dev, timings, mode, conv_impl="pallas"):
    """The stage-1 train step at batch 7 x 256 rays, eager, then captured
    from the eager state. Returns the launch counts of one update step and
    of one frozen step, eager and through replay, and the captured model's
    state dict after the phase."""
    import torch

    from neural_jacobian_field_torch.training import (
        make_train_step, step_randomness, train_step)

    fused = conv_impl == "pallas_fused"
    label = "train fused" if fused else f"train {mode}"
    tag = {(False, "epipolar"): "train_", (False, "exact"): "exact_train_",
           (True, "epipolar"): "fused_train_"}[(fused, mode)]
    model, state, batch, g = train_setup(dev, mode, conv_impl)

    yx, draws = step_draws(dev, g)
    compare_grads(label, state, batch, yx, draws, ("encoder.", "proposal_networks_", "decoder."))

    # launch counts of each step type; then the gradients reach the params
    want = stage1_counts(mode, "K10" if fused else "K9-fwd")
    counts = gate_counts(state, batch, g, label, want)
    dead = [name for name, p in model.named_parameters()
            if name.startswith(("encoder.", "decoder.density_head.", "decoder.color_head.",
                                "proposal_networks_"))
            and (p.grad is None or not bool(p.grad.abs().sum() > 0))]
    print(f"{label} gradients: {len(dead)} encoder / density-head / colour-head / "
          f"proposal parameters without a non-zero gradient after an update step {dead[:4]}")
    check(not dead, "a parameter the loss reaches got no gradient")

    # eager step times (host clock around synchronised steps), peak memory
    peak_window(dev)
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
    eager_alloc, eager_peak = peaks_gib(dev)
    timings[tag + "peak_mem_gib"] = eager_alloc
    timings[tag + "peak_reserved_gib"] = eager_peak
    print(f"{label} step (batch {TRAIN_B} x {TRAIN_RAYS} rays, 480x640 context, bf16, "
          f"{conv_impl}), eager: update {upd_ms:.2f} ms, frozen {frz_ms:.2f} ms (medians of "
          f"{len(times[True])} / {len(times[False])}); 5 frozen + 1 update cycle "
          f"{timings[tag + 'cycle_rays_per_s']:.1f} rays/s; peak {eager_alloc:.2f} GiB "
          f"allocated, {eager_peak:.2f} GiB reserved")
    if fused and "train_update_step_ms" in timings:
        print(f"{label} vs pallas (epipolar, this call), eager: update {upd_ms:.2f} vs "
              f"{timings['train_update_step_ms']:.2f} ms, frozen {frz_ms:.2f} vs "
              f"{timings['train_frozen_step_ms']:.2f} ms")

    # captured against eager: three steps from this state, five times
    # eagerly, then once through CUDA graphs in a fresh model loaded with
    # the state
    plan = [(u, *step_randomness(state, batch, g)) for u in (True, False, False)]
    snap = snapshot(state)
    names, eager, ops = eager_runs(state, batch, plan)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    model, state = new_train_state(dev, mode, conv_impl)
    restore(state, snap)
    t0 = time.perf_counter()
    _, captured = run_steps(state, batch, plan)  # captures the update and frozen programs
    print(f"{label} captured the update and frozen programs and ran 3 steps in "
          f"{time.perf_counter() - t0:.2f} s")
    compare_captured(label, names, eager, captured, ops, exact=True)

    counts.update(replay_counts(state, batch, g, label, want))

    stacked, (alloc, peak) = captured_step_times(dev, state, batch, g, label, tag, timings)
    timings[tag + "captured_peak_mem_gib"] = alloc
    timings[tag + "captured_peak_reserved_gib"] = peak
    print(f"{label} captured cycle peak memory (replays of the three programs, their shared "
          f"pool): {alloc:.2f} GiB allocated, {peak:.2f} GiB reserved; {peak / eager_peak:.3f}x "
          f"the eager steps' {eager_peak:.2f} GiB reserved (bound 1.3)")
    check(peak <= 1.3 * eager_peak, f"{label}: captured peak memory above 1.3x the eager step's")
    dispatch_run(state, stacked, g, label)
    del stacked

    # the loss falls over the loss steps on this batch at one fixed pixel
    # set (captured steps on the schedule's gate; the stratified draws
    # change every step)
    fixed_yx, _ = step_draws(dev, g)
    step = make_train_step(model, state.cfg)
    losses = [float(step(state, batch, yx=fixed_yx, generator=g)["loss/total"])
              for _ in range(LOSS_STEPS)]
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    print(f"{label} loss over {len(losses)} captured steps: {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; mean of the first 3 {first:.5f}, of the last 3 {last:.5f} "
          f"(bound: finite, last < first)")
    check(all(math.isfinite(v) for v in losses) and last < first, "the train loss did not fall")
    timings[tag + "loss_first3"], timings[tag + "loss_last3"] = first, last
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, state, batch
    gc.collect()  # the model and its programs' cache refer to each other
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


def new_action_state(dev, mode, stage1=None, variant=None):
    """The flagship model under pallas_fused (or the phase-10 variant's) and
    its stage-2 train state, warm-started from the stage-1 state dict
    `stage1` when given."""
    from neural_jacobian_field_torch.models.model import flagship_model_cfg
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = (variant.model(dev, SEED + 6) if variant else
             new_model(dev, flagship_model_cfg(conv_impl="pallas_fused",
                                               pixel_feature_mode=mode), SEED + 6))
    cfg = TrainCfg(mode="action", lr=ACTION_LR, warm_up_steps=TRAIN_WARMUP,
                   rays_per_batch=TRAIN_RAYS)
    return model, create_train_state(model, cfg, init_params=stage1)


def action_setup(dev, mode, supervision, stage1=None, variant=None):
    """`new_action_state`, an action batch and a generator."""
    import torch

    model, state = new_action_state(dev, mode, stage1, variant)
    return model, state, action_batch(dev, supervision), torch.Generator(
        device=dev).manual_seed(SEED + 7)


def action_names(model) -> list:
    """The parameters stage 2 trains, by the decoder's action pattern (the
    JAX optax mask): the decoder's whose name holds action_param_pattern,
    "jacobian_head" for the Jacobian MLP, "jacobian" for the transformer,
    "flow_head" for the flow MLP."""
    from neural_jacobian_field_torch.models.decoders import action_param_pattern

    pattern = action_param_pattern(model.cfg.action_decoder)
    return sorted(n for n, _ in model.named_parameters()
                  if n.startswith("decoder.") and pattern in n)


def running_means_gate(model, stats0):
    """Stage 2 runs the encoder in training mode: with BatchNorm every
    running mean must have moved from `stats0` (buffers by name before the
    steps); other norms keep no running statistics, and the model must hold
    none. Returns (passed, a line saying which)."""
    import torch

    bufs = {n: b.detach().cpu() for n, b in model.named_buffers()}
    means = [n for n in bufs if n.endswith("running_mean")]
    if model.cfg.encoder.norm_type != "batch":
        return not means, (f"{model.cfg.encoder.norm_type} norm: {len(means)} running means "
                           f"(bound 0)")
    still = [n for n in means if torch.equal(bufs[n], stats0[n])]
    return bool(means) and not still, (f"{len(means) - len(still)}/{len(means)} BatchNorm "
                                       f"running means moved")


def action_phase(dev, timings, mode, supervision, stage1, variant=None, want=None):
    """The stage-2 train step under pallas_fused (or of the phase-10
    variant, whose launches per step are `want`), warm-started from the
    stage-1 state dict `stage1`: flow at batch 7 x 256 rays, or tracks at
    7 x TRACKS; eager, then captured from the eager state. The trainable
    parameters are the decoder's action parameters (`action_names`), the
    rest must stay bit for bit as the warm start left them, and the
    BatchNorm running means must move (a model without BatchNorm must have
    none). Returns the launch counts of one step, eager and through
    replay."""
    import torch

    from neural_jacobian_field_torch.models.decoders import action_param_pattern
    from neural_jacobian_field_torch.training import (
        host_step_schedule, make_train_step, step_randomness, train_step)

    label = f"action {mode}" if supervision == "flow" else "action tracks"
    if variant:
        label = f"{variant.name} action"
    tag = label.replace(" ", "_") + "_"
    rays = TRAIN_RAYS if supervision == "flow" else TRACKS
    model, state, batch, g = action_setup(dev, mode, supervision, stage1, variant)
    trained = action_names(model)
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    check(trained and trainable == trained,
          f"{label}: the trainable parameters {trainable[:4]}... are not the decoder's action "
          f"parameters {trained[:4]}...")
    frozen0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
               if n not in trained}
    stats0 = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}

    yx, draws = step_draws(dev, g, rays)
    reached = compare_grads(label, state, batch, yx, draws, ("decoder.",))
    check(reached == trainable, f"{label}: gradients on {reached[:4]}..., not the action "
                                f"parameters'")

    want = want or all_zero_but(
        {"K10": 24, "K6-fwd": 3, "K5": 1, "K7-tz-fwd": 3, "K7-tz-bwd": 1}
        if mode == "epipolar" else
        {"K10": 24, "K6-fwd": 2, "K1-fwd": 2, "K5": 1, "K7-fwd": 3, "K7-bwd": 1})
    want = {"frozen": want, "update": want}  # the gate moves no stage-2 launch
    counts = gate_counts(state, batch, g, label, want)

    def timed_steps(step_fn):
        times = []
        for _ in range(8):
            updated, _ = host_step_schedule(state.step, state.steps_since_update,
                                            model.cfg.rendering)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(updated)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    peak_window(dev)
    step_ms = timed_steps(lambda u: train_step(state, batch, g, u))
    timings[tag + "step_ms"] = step_ms
    timings[tag + "rays_per_s"] = TRAIN_B * rays / step_ms * 1e3
    eager_alloc, eager_peak = peaks_gib(dev)
    timings[tag + "peak_mem_gib"], timings[tag + "peak_reserved_gib"] = eager_alloc, eager_peak
    print(f"{label} step (batch {TRAIN_B} x {rays} rays, 480x640 context, bf16, "
          f"{model.cfg.encoder.conv_impl}), eager: {step_ms:.2f} ms (median of 8), "
          f"{timings[tag + 'rays_per_s']:.1f} rays/s; peak {eager_alloc:.2f} GiB allocated, "
          f"{eager_peak:.2f} GiB reserved")

    # captured against eager, as in the stage-1 phases (here nothing with
    # grad reaches the atomic ops: the eager runs repeat bit for bit)
    plan = [(u, *step_randomness(state, batch, g)) for u in (True, False, False)]
    snap = snapshot(state)
    names, eager, ops = eager_runs(state, batch, plan)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    model, state = new_action_state(dev, mode, variant=variant)
    restore(state, snap)
    captured_from = state.step
    _, captured = run_steps(state, batch, plan)
    compare_captured(label, names, eager, captured, ops)
    counts.update(replay_counts(state, batch, g, label, want))
    steps = {u: make_train_step(model, state.cfg, static_updated=u) for u in (True, False)}
    peak_window(dev)
    cap_ms = timed_steps(lambda u: steps[u](state, batch, generator=g))
    timings[tag + "captured_step_ms"] = cap_ms
    timings[tag + "captured_rays_per_s"] = TRAIN_B * rays / cap_ms * 1e3
    alloc, peak = peaks_gib(dev)
    timings[tag + "captured_peak_mem_gib"] = alloc
    timings[tag + "captured_peak_reserved_gib"] = peak
    print(f"{label} captured step: {cap_ms:.2f} ms (median of 8 replays), "
          f"{timings[tag + 'captured_rays_per_s']:.1f} rays/s; peak {alloc:.2f} GiB allocated, "
          f"{peak:.2f} GiB reserved, {peak / eager_peak:.3f}x the eager steps' reserved "
          f"(bound 1.3); {card_line()}")
    check(peak <= 1.3 * eager_peak, f"{label}: captured peak memory above 1.3x the eager step's")

    # the loss on a fixed batch and pixel set, captured steps: the near-zero
    # head makes the first steps' loss artificially low, so it must fall
    # from its early peak
    fixed_yx, _ = step_draws(dev, g, rays)
    step = make_train_step(model, state.cfg)
    losses = [float(step(state, batch, yx=None if batch.pixel_selector is not None
                         else fixed_yx, generator=g)["loss/total"])
              for _ in range(LOSS_STEPS)]
    peak_loss, last = max(losses[:5]), statistics.mean(losses[-3:])
    print(f"{label} loss over {len(losses)} captured steps (lr {ACTION_LR:g}): "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; peak of the first 5 {peak_loss:.5f}, mean of the last 3 {last:.5f} "
          f"(bound: finite, last < peak)")
    check(all(math.isfinite(v) for v in losses) and last < peak_loss,
          f"{label}: the loss did not fall from its early peak")
    timings[tag + "loss_peak5"], timings[tag + "loss_last3"] = peak_loss, last

    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    changed = [n for n in frozen0 if not torch.equal(params[n], frozen0[n])]
    moved = [n for n in trained if not torch.equal(params[n], stage1[n].cpu())]
    stats_ok, stats_line = running_means_gate(model, stats0)
    print(f"{label} after {state.step} steps (the last {state.step - captured_from} captured): "
          f"{len(frozen0) - len(changed)}/{len(frozen0)} parameters outside the action "
          f"pattern {action_param_pattern(model.cfg.action_decoder)!r} bit-identical to the "
          f"warm start (passed={not changed}); {stats_line}; {len(moved)}/{len(trained)} "
          f"action parameters moved")
    check(not changed and stats_ok and moved,
          f"{label}: frozen parameters moved {changed[:4]}, or the running statistics gate "
          f"failed, or no action parameter moved")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ phase 8

CLI_STEPS, CLI_SPC, CLI_WARMUP, CLI_VAL = 198, 6, 12, 195


def cli_overrides(scene, work):
    """The flagship CLI run's overrides (configurations/config.yaml with
    dataset_allegro + model_allegro): the scene, bf16, K9 convs (the YAML
    leaves the encoder's conv_impl at the JAX default, "xla"; bench.py's
    flagship takes "pallas"), six steps per call, a proposal warm-up short
    enough to reach the steady programs, validation once near the end."""
    return [f"dataset.root={scene}", "dataset.max_num_frames_per_traj=4",
            "training.compute_dtype=bfloat16", "model.encoder.conv_impl=pallas",
            f"training.steps_per_call={CLI_SPC}",
            f"model.rendering.proposal_warmup={CLI_WARMUP}", f"training.max_steps={CLI_STEPS}",
            f"training.val_check_interval={CLI_VAL}", "validation.video.num_frames=2",
            f"checkpoint.dir={work / 'ck1'}", f"checkpoint.every_n_train_steps={CLI_STEPS}"]


def cli_run(dev, label, overrides, log_dir, profile=0, steps=CLI_STEPS):
    """train() in process on the card from the dotted overrides, `steps`
    steps; returns the state, run.json, the launch counts (reset just
    before, read just after) and the peak reserved memory (GiB)."""
    import torch

    from neural_jacobian_field_torch import train as cli
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config
    from neural_jacobian_field_torch.ops import kernels as K

    cfg = get_typed_root_config(load_config(CONFIG_DIR, overrides))
    peak_window(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = cli.train(cfg, log_dir=log_dir, device=dev, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check_no_legacy(label)
    run = json.loads((log_dir / "run.json").read_text())
    peak = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    losses = [v for _, v in run["losses"]]
    print(f"{label}: {run['steps']} steps in {wall:.1f} s (set-up, captures and validation "
          f"included); loader paths {run['loader_paths']}, decoders {run['decoders']}; "
          f"{run['programs']} captured programs ({run['steady_programs']} steady "
          f"{CLI_SPC}-step); logged losses {losses}; peak reserved {peak:.2f} GiB")
    print(f"{label} launches: {counts}")
    check(run["steps"] >= steps, f"{label}: stopped early")
    check(all(math.isfinite(v) for v in losses), f"{label}: a logged loss is not finite")
    return state, run, counts, peak, wall


def cli_phase(dev, timings, paths, work):
    """Phase 8: the training CLI at full width on the card (lines "cli"): a
    480x640 synthetic scene written by the port under `work` (returned; phase
    10 trains on it too), stage 1 at the flagship
    configuration through train(), a check that a train replay after the
    validation render still equals eager steps, stage 2 warm-started from
    stage 1's checkpoint, a short tracks run; the loader alone, the idle
    share of one steady window, the rates beside the captured cycle of
    phase 5."""
    import importlib.util

    import torch

    from neural_jacobian_field_torch.data import (
        collate, get_dataset, make_synthetic_scene, native)
    from neural_jacobian_field_torch.parallel import to_device

    import PIL
    import yaml

    print(f"cli machine: PyYAML {yaml.__version__}, Pillow {PIL.__version__}, matplotlib "
          f"{importlib.util.find_spec('matplotlib') is not None}, native decoder "
          f"{native.status()}")
    t0 = time.perf_counter()
    scene = make_synthetic_scene(work / "scene", num_cameras=3, num_trajs=3,
                                 frames_per_traj=4, height=H, width=W, action_dim=16)
    print(f"cli scene: 3 cameras x 3 trajectories x 4 frames at {H}x{W}, action_dim 16 "
          f"(dataset_allegro disables 8: the model's 8), written in "
          f"{time.perf_counter() - t0:.1f} s")
    base = cli_overrides(scene, work)

    # stage 1, its first steady dispatch (after the log point at 96)
    # under torch.profiler, the logged window 102-192 after it
    state, run, counts, peak, wall = cli_run(dev, "cli stage1", base, work / "logs1",
                                             profile=1)
    paths["cli_stage1"] = counts
    check_cli_counts("cli stage1", counts, run["steps"], paths, CLI_STAGE1_KERNELS)
    rows = [json.loads(x) for x in (work / "logs1" / "metrics.jsonl").read_text().splitlines()]
    rates = {r["step"]: r["perf/rays_per_sec"] for r in rows}
    steady = rates[max(rates)]
    cycle = timings.get("train_program6_cycle_rays_per_s")
    check("profile" in run, "cli stage1: no steady dispatch was traced")
    prof = run["profile"]
    timings.update(cli_stage1_rays_per_s=steady, cli_stage1_peak_reserved_gib=peak,
                   cli_stage1_s=wall)
    if cycle:
        timings["cli_stage1_host_cost"] = 1.0 - steady / cycle
    if prof["device_events"]:
        timings["cli_stage1_idle_share"] = prof["idle_share"]
    print(f"cli stage1 logged perf/rays_per_sec by step {rates}; steady window (steps "
          f"{prof['steps'][1]}-{max(rates)}, the traced dispatch left out) {steady:.1f} "
          f"rays/s against phase 5's captured 5-frozen + 1-update cycle as one 6-step "
          f"program {cycle or float('nan'):.1f} rays/s: CLI / captured "
          f"{steady / cycle if cycle else float('nan'):.3f}, the host pipeline's cost "
          f"1 - CLI / captured = {1 - steady / cycle if cycle else float('nan'):.3f}")
    print(f"cli stage1 one steady dispatch under torch.profiler (steps "
          f"{prof['steps'][0]}-{prof['steps'][1]}, inside the steady window, profiler "
          f"overhead included): traced wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share "
          + (f"{prof['idle_share']:.4f}" if prof["device_events"] else
             "not measured (the profiler delivered no device event)")
          + f", {prof['device_events']} device events")
    check(run["steady_programs"] >= 1, "cli stage1: no steady 6-step program was reached")
    frames = run["validation_frames"]
    print(f"cli stage1 validation frames written: {len(frames)} "
          f"{[Path(f).name for f in frames]}")
    check(len(frames) == 6 and all(Path(f).stat().st_size > 0 for f in frames),
          "cli stage1: validation wrote no frames")

    # a train replay after the validation render (its programs share the
    # model) against eager steps from the same state
    ds = get_dataset(state_cfg_dataset(base), "train")
    batch = to_device(collate([ds[i] for i in range(TRAIN_B)]), dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    plan = [(gate, *step_draws(dev, g)) for gate in (True, False, False)]
    names, eager, ops = eager_runs(state, batch, plan, runs=3)
    snap = snapshot(state)
    _, captured = run_steps(state, batch, plan)
    restore(state, snap)
    compare_captured("cli stage1 after validation", names, eager, captured, ops, exact=True)
    del state, batch, eager, captured, snap
    gc.collect()
    torch.cuda.empty_cache()

    # the loader alone, as the CLI builds it, in both stages' modes
    for stage, mode in (("stage1", "perception"), ("stage2", "action")):
        ds = get_dataset(dataclasses.replace(state_cfg_dataset(base), mode=mode), "train")
        bps, made = loader_alone(dev, ds)
        timings[f"cli_{stage}_loader_batches_per_s"] = bps
        print(f"cli loader alone, {mode} (batch {TRAIN_B}, 16 threads, pinned, {made}): "
              f"{bps:.2f} batches/s = {bps * TRAIN_B * TRAIN_RAYS:.1f} rays/s of steps it "
              f"can feed")

    # stage 2: flow, warm-started from stage 1's checkpoint
    s2 = [*base, "dataset.mode=action", f"checkpoint.load={work / 'ck1'}",
          f"checkpoint.dir={work / 'ck2'}"]
    state, run, counts, peak, wall = cli_run(dev, "cli stage2", s2, work / "logs2")
    paths["cli_stage2"] = counts
    check_cli_counts("cli stage2", counts, run["steps"], paths, CLI_STAGE2_KERNELS)
    rows = [json.loads(x) for x in (work / "logs2" / "metrics.jsonl").read_text().splitlines()]
    rates = {r["step"]: r["perf/rays_per_sec"] for r in rows}
    timings.update(cli_stage2_rays_per_s=rates[max(rates)], cli_stage2_peak_reserved_gib=peak,
                   cli_stage2_s=wall)
    # the warm start's parameters: stage 1's checkpoint
    stage1 = torch.load(work / "ck1" / f"ckpt_{CLI_STEPS:09d}.pt", map_location="cpu",
                        weights_only=True)["model"]
    moved, frozen_moved = cli_freezing_gate("cli stage2", state.model, stage1)
    print(f"cli stage2 logged perf/rays_per_sec by step {rates}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # tracks: _pad_tracks and the tracks batch on the card
    tr = [*base, "dataset.mode=action", "dataset.action_supervision_type=tracks",
          "training.steps_per_call=1", "training.max_steps=4", "training.val_check_interval=0",
          f"checkpoint.load={work / 'ck1'}", f"checkpoint.dir={work / 'ck3'}"]
    state, run, counts, _, _ = cli_run(dev, "cli tracks", tr, work / "logs3", steps=4)
    paths["cli_tracks"] = counts
    check(run["steps"] == 4 and counts["K7-tz-bwd"] > 0, "cli tracks: the steps did not run")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return scene


def cli_freezing_gate(label, model, stage1):
    """A stage-2 CLI run moved only the decoder's action parameters
    (`action_names`) from its warm start `stage1` (a state dict), and at
    least one of them. Returns (moved, frozen that moved)."""
    import torch

    from neural_jacobian_field_torch.models.decoders import action_param_pattern

    trained = set(action_names(model))
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach().cpu(), stage1[k])]
    frozen_moved = [k for k in moved if k not in trained]
    print(f"{label}: {len(moved)} parameters moved from the warm start, all {len(trained)} of "
          f"them action parameters (pattern "
          f"{action_param_pattern(model.cfg.action_decoder)!r}): {not frozen_moved}; "
          f"{len(stage1) - len(moved)}/{len(stage1)} bit for bit unchanged")
    check(moved and not frozen_moved,
          f"{label}: frozen parameters moved {frozen_moved[:4]} (or none moved)")
    return moved, frozen_moved


# the kernels each CLI stage's steps run at the flagship configuration:
# stage 2 trains the Jacobian head alone, so no encoder or packing backward
CLI_STAGE1_KERNELS = ("K9-fwd", "K9-dgrad", "K9-wgrad", "K6-fwd", "K6-bwd", "K5", "K7-tz-fwd",
                      "K7-tz-bwd", "K1-bwd-rows", "K1-bwd-upsample", "K1-bwd-small")
CLI_STAGE2_KERNELS = ("K9-fwd", "K6-fwd", "K5", "K7-tz-fwd", "K7-tz-bwd")


def check_cli_counts(label, counts, steps, paths, kernels):
    """Each kernel of the stage's steps launched at least steps times phase
    5's frozen step's count of it (an update step launches as many or more;
    the capture warm-ups and the validation render add to it), and at
    least once where phase 5's counts are not at hand."""
    per_step = paths.get("train_frozen", {})
    short = {k: (counts[k], steps * per_step.get(k, 0)) for k in kernels
             if counts[k] < max(steps * per_step.get(k, 0), 1)}
    print(f"{label} launch gate: " + ", ".join(
        f"{k} {counts[k]} >= {max(steps * per_step.get(k, 0), 1)}" for k in kernels))
    check(not short, f"{label}: kernels launched fewer times than its {steps} steps need "
                     f"(count, needed) {short}")


def loader_alone(dev, ds, warm=5, timed=30):
    """Batches/s of the CLI's DataLoader (16 threads, pinned on the card) over
    `timed` batches after `warm`, nothing else running; and its path counts."""
    from neural_jacobian_field_torch.data import DataLoader

    loader = DataLoader(ds, TRAIN_B, num_workers=16, pin_memory=dev.type == "cuda")
    it = iter(loader)
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    for _ in range(timed):
        next(it)
    bps = timed / (time.perf_counter() - t0)
    loader.close()
    return bps, dict(loader.paths)


def state_cfg_dataset(overrides):
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config

    return get_typed_root_config(load_config(CONFIG_DIR, overrides)).dataset


# ------------------------------------------------------------------ phase 9

def e2e_phase(dev, timings, paths):
    """Phase 9: the e2e drive (neural_jacobian_field_torch.verify_e2e) on
    the card, its checks as gates, in float32 and in bf16 (the bf16 run with
    K9 convs: the fused trunks take K7 with one 128-wide latent level, K9
    the six 64-channel stride-1 convs); the loss curves side by side."""
    import tempfile

    import torch

    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.verify_e2e import run

    outs, total = {}, None
    for label, extra in (("float32", []), ("bfloat16", ["training.compute_dtype=bfloat16",
                                                        "model.encoder.conv_impl=pallas"])):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="njf_e2e_") as root:
            outs[label] = run(dev, extra, root=root,
                              log=lambda m, lb=label: print(f"e2e {lb}: {m}"))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check_no_legacy(f"e2e {label}")
        timings[f"e2e_{label}_s"] = time.perf_counter() - t0
        print(f"e2e {label}: {timings[f'e2e_{label}_s']:.1f} s; launches {counts}")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    check(total["K7-fwd"] > 0 and total["K9-fwd"] > 0, "e2e: the bf16 run reached no K7 or K9")
    paths["e2e"] = total
    for stage, key, every in (("stage1 rgb", "stage1_rgb", 10), ("stage2 total", "stage2_total",
                                                                 10)):
        a, b = outs["float32"][key], outs["bfloat16"][key]
        print(f"e2e {stage} loss, float32 | bf16, every {every} steps: " + "; ".join(
            f"{i}: {a[i]:.5f} | {b[i]:.5f}" for i in range(0, len(a), every))
              + f"; last: {a[-1]:.5f} | {b[-1]:.5f}")
    print(f"e2e flow residual float32 {outs['float32']['flow_residual']:.4%} bf16 "
          f"{outs['bfloat16']['flow_residual']:.4%}")
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 10

@dataclasses.dataclass(frozen=True)
class Variant:
    """A model phase 10 drives beside the flagship: its name on the lines, its
    ModelCfg, its compute dtype (float32 where None) and remat."""

    name: str
    cfg: object
    dtype: object = "bfloat16"
    remat: bool = False

    def model(self, dev, seed):
        return new_model(dev, self.cfg, seed, self.dtype, self.remat)


def yaml_model_cfg(*overrides):
    """The model section of configurations/ under these overrides, as the
    CLI reads it."""
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config

    return get_typed_root_config(load_config(CONFIG_DIR, list(overrides))).model


TRANSFORMER_OVERRIDES = ("model=model_allegro_transformer", "model.encoder.conv_impl=pallas")
FLOW_MLP_OVERRIDES = ("model.action_decoder.name=flow_mlp", "model.encoder.conv_impl=pallas")
# a stage-2 step of a decoder whose action parameters hold no fused trunk:
# the encoder (K9, forward only), the packing, K5, the proposal and density
# trunks forward; no kernel backward
STAGE2_FORWARD_ONLY = {"K9-fwd": 24, "K6-fwd": 3, "K5": 1, "K7-tz-fwd": 2}


def variant_train_phase(dev, timings, variant, want, remat_variant=None):
    """A stage-1 step of a phase-10 variant at batch 7 x 256 rays: launches
    of an eager frozen and update step (`want`), the eager peak memory over
    three steps, the three steps (update, frozen, frozen) captured in a
    fresh model against five eager runs from the same state (the phase-5
    rule), the launches through replay, and the 5-frozen + 1-update cycle
    as six replays and as one 6-step program (rays/s, peak memory). With
    `remat_variant` (the model with remat=True): the same three steps from
    the same state, eager (peak memory) and captured, the captured ones held
    to the remat-off eager runs by the same rule, and its cycle and peak
    memory beside. Returns the launch counts and the stage-1 state dict."""
    import torch

    from neural_jacobian_field_torch.training import step_randomness

    label, tag = f"{variant.name} train", f"{variant.name}_train_"
    model, state, batch, g = train_setup(dev, "epipolar", variant=variant)
    counts = gate_counts(state, batch, g, label, want)
    plan = [(u, *step_randomness(state, batch, g)) for u in (True, False, False)]
    snap = snapshot(state)

    def eager_peak(st):
        peak_window(dev)
        with st.model.programs.eager():
            run_steps(st, batch, plan)
        restore(st, snap)
        return peaks_gib(dev)

    peaks = {"off": eager_peak(state)}
    names, eager, ops = eager_runs(state, batch, plan)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    model, state = new_train_state(dev, "epipolar", variant=variant)
    restore(state, snap)
    _, captured = run_steps(state, batch, plan)
    compare_captured(label, names, eager, captured, ops, exact=True)
    counts.update(replay_counts(state, batch, g, label, want))
    stacked, cycle_peaks = captured_step_times(dev, state, batch, g, label, tag, timings)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    timings[tag + "peak_mem_gib"], timings[tag + "peak_reserved_gib"] = peaks["off"]
    timings[tag + "captured_peak_mem_gib"], timings[tag + "captured_peak_reserved_gib"] = \
        cycle_peaks
    print(f"{label} peak memory: eager steps {peaks['off'][0]:.2f} GiB allocated, "
          f"{peaks['off'][1]:.2f} reserved; captured cycle {cycle_peaks[0]:.2f} allocated, "
          f"{cycle_peaks[1]:.2f} reserved; {card_line()}")
    del model, state, stacked
    gc.collect()
    torch.cuda.empty_cache()
    if remat_variant is None:
        return counts, trained

    rlabel, rtag = f"{label} remat", f"{tag}remat_"
    model, state = new_train_state(dev, "epipolar", variant=remat_variant)
    restore(state, snap)
    peaks["on"] = eager_peak(state)
    _, captured = run_steps(state, batch, plan)
    compare_captured(f"{rlabel} (against the remat-off eager runs)", names, eager, captured,
                     ops, exact=True)
    restore(state, snap)
    stacked, remat_cycle = captured_step_times(dev, state, batch, g, rlabel, rtag, timings)
    timings[rtag + "peak_mem_gib"], timings[rtag + "peak_reserved_gib"] = peaks["on"]
    timings[rtag + "captured_peak_mem_gib"], timings[rtag + "captured_peak_reserved_gib"] = \
        remat_cycle
    print(f"{rlabel}: eager peak {peaks['on'][0]:.2f} GiB allocated against "
          f"{peaks['off'][0]:.2f} without remat ({peaks['on'][0] / peaks['off'][0]:.3f}x); "
          f"captured cycle {remat_cycle[1]:.2f} GiB reserved against {cycle_peaks[1]:.2f} "
          f"({remat_cycle[1] / cycle_peaks[1]:.3f}x); cycle as one 6-step program "
          f"{timings[rtag + 'program6_cycle_rays_per_s']:.1f} rays/s against "
          f"{timings[tag + 'program6_cycle_rays_per_s']:.1f}")
    del model, state, stacked
    gc.collect()
    torch.cuda.empty_cache()
    return counts, trained


def median_step_ms(fn, n=5):
    """Median milliseconds of n synchronised calls of fn (host clock)."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def variant_action_steps(dev, variant, want, timings):
    """Three stage-2 steps (flow, batch 7 x 256) of a phase-10 variant from
    seeded weights: the trainable parameters are the decoder's action
    parameters, launches per gate (`want`), eager and through replay, the
    steps captured in a fresh model against three eager runs (the phase-5
    rule), the captured update step's time, then the freezing: every other
    parameter bit for bit as it was, the action parameters moved, and the
    running-statistics gate. Returns the launch counts."""
    import torch

    from neural_jacobian_field_torch.training import make_train_step, step_randomness

    label = f"{variant.name} action"
    want = {"frozen": want, "update": want}
    model, state, batch, g = action_setup(dev, "epipolar", "flow", variant=variant)
    trained = action_names(model)
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    check(trained and trainable == trained,
          f"{label}: trainable {trainable[:4]}... are not the action parameters {trained[:4]}")
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    counts = gate_counts(state, batch, g, label, want)
    plan = [(u, *step_randomness(state, batch, g)) for u in (True, False, False)]
    snap = snapshot(state)
    names, eager, ops = eager_runs(state, batch, plan, runs=3)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    model, state = new_action_state(dev, "epipolar", variant=variant)
    restore(state, snap)
    _, captured = run_steps(state, batch, plan)
    compare_captured(label, names, eager, captured, ops)
    counts.update(replay_counts(state, batch, g, label, want))
    update = make_train_step(model, state.cfg, static_updated=True)
    ms = timings[f"{variant.name}_action_captured_step_ms"] = median_step_ms(
        lambda: update(state, batch, generator=g))
    print(f"{label} captured update step (batch {TRAIN_B} x {TRAIN_RAYS} rays): {ms:.2f} ms "
          f"(median of 5), {TRAIN_B * TRAIN_RAYS / ms * 1e3:.1f} rays/s; {card_line()}")
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    changed = [n for n in params if n not in trained and not torch.equal(params[n], before[n])]
    moved = [n for n in trained if not torch.equal(params[n], before[n])]
    stats_ok, stats_line = running_means_gate(model, stats0)
    print(f"{label} after {state.step} steps: {len(params) - len(trained) - len(changed)}/"
          f"{len(params) - len(trained)} frozen parameters bit for bit unchanged; "
          f"{len(moved)}/{len(trained)} action parameters ({trained[0].split('.')[1]}...) "
          f"moved; {stats_line}")
    check(not changed and moved and stats_ok,
          f"{label}: frozen parameters moved {changed[:4]}, no action parameter moved, or the "
          f"running-statistics gate failed")
    del model, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def transformer_cli(dev, timings, paths, scene, work):
    """The CLI at model=model_allegro_transformer on phase 8's scene (bf16, K9
    convs, 6 steps per call): stage 1 for 96 steps (a log point at 96, the
    steady programs reached), then stage 2 (flow) warm-started from its
    checkpoint for 96 steps; finite logged losses, the kernels of each
    stage at least its steps times phase 5's per-step counts (stage 2 runs
    no kernel backward: the transformer is cuBLAS's), and stage 2's
    freezing by the pattern against the checkpoint."""
    import torch

    steps = 96
    base = [*cli_overrides(scene, work), *TRANSFORMER_OVERRIDES[:1],
            f"training.max_steps={steps}", f"checkpoint.every_n_train_steps={steps}",
            f"checkpoint.dir={work / 'ckt1'}"]
    for stage, extra, kernels in (
            ("stage1", [], CLI_STAGE1_KERNELS),
            ("stage2", ["dataset.mode=action", f"checkpoint.load={work / 'ckt1'}",
                        f"checkpoint.dir={work / 'ckt2'}"], tuple(STAGE2_FORWARD_ONLY))):
        label = f"transformer cli {stage}"
        state, run, counts, peak, wall = cli_run(dev, label, [*base, *extra],
                                                 work / f"logs_t{stage}", steps=steps)
        paths[f"transformer_cli_{stage}"] = counts
        check_cli_counts(label, counts, run["steps"], paths, kernels)
        check(run["losses"] and all(math.isfinite(v) for _, v in run["losses"]),
              f"{label}: no finite logged loss")
        rows = [json.loads(x) for x in
                (work / f"logs_t{stage}" / "metrics.jsonl").read_text().splitlines()]
        timings.update({f"transformer_cli_{stage}_rays_per_s": rows[-1]["perf/rays_per_sec"],
                        f"transformer_cli_{stage}_peak_reserved_gib": peak,
                        f"transformer_cli_{stage}_s": wall})
        print(f"{label}: logged loss {run['losses']}, perf/rays_per_sec "
              f"{rows[-1]['perf/rays_per_sec']:.1f} at step {rows[-1]['step']}")
        if stage == "stage2":
            ckpt = torch.load(work / "ckt1" / f"ckpt_{steps:09d}.pt", map_location="cpu",
                              weights_only=True)["model"]
            cli_freezing_gate(label, state.model, ckpt)
        del state
        gc.collect()
        torch.cuda.empty_cache()


def other_decoders_phase(dev, timings, paths, cam, robot, scene, work):
    """Phase 10: the other decoders and norms (lines "transformer",
    "defaults", "flow_mlp"):
      - model_allegro_transformer (the YAML's model, bf16, epipolar, fused
        trunks, BatchNorm, K9 convs): the 480x640 render eager against
        captured, inverse dynamics (phase 4's), stage 1 captured against
        eager with the cycle's rays/s, then with remat (its peak memory, its
        steps held to the remat-off ones), stage 2 as phase 6 (freezing by
        "jacobian"), and the CLI;
      - the JAX defaults, Model(make_model_cfg()): float32, exact, group
        norm, cuDNN convs, plain trunks: the render eager against captured,
        a stage-1 step eager and captured with finite non-zero gradients on
        every encoder parameter;
      - flow_mlp (model_allegro's with the flow decoder, bf16): one render
        chunk, encode_image refused, stage-2 steps captured against eager,
        freezing by "flow_head"."""
    import torch

    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import RenderingInput, make_model_cfg
    from neural_jacobian_field_torch.training import make_train_step, step_randomness

    n = H * W // PATCH

    def render_all(model):
        return lambda: render_camera(model, cam, robot, Z_NEAR, Z_FAR, H, W, patch_size=PATCH)

    def free():
        gc.collect()  # a model and its programs' cache refer to each other
        torch.cuda.empty_cache()

    # model_allegro_transformer
    tv = Variant("transformer", yaml_model_cfg(*TRANSFORMER_OVERRIDES))
    print(f"transformer config: {tv.cfg.action_decoder}")
    model = build_model(dev, None, cfg=tv.cfg)
    _, paths["transformer_serve"] = render_vs_eager(
        dev, model, "transformer", render_all(model),
        all_zero_but({"K9-fwd": 24, "K6-fwd": 2 + n, "K5": n, "K7-tz-fwd": 2 * n}), 24, timings,
        "transformer_")
    inverse_dynamics_phase(dev, model, cam, robot, timings, "transformer", tag="transformer_")
    del model
    free()
    counts, stage1 = variant_train_phase(dev, timings, tv, stage1_counts("epipolar"),
                                         dataclasses.replace(tv, remat=True))
    paths["transformer_train_update"] = counts["update"]
    paths["transformer_train_update_captured"] = counts["update captured"]
    counts = action_phase(dev, timings, "epipolar", "flow", stage1, tv,
                          all_zero_but(STAGE2_FORWARD_ONLY))
    paths["transformer_action"] = counts["update"]
    paths["transformer_action_captured"] = counts["update captured"]
    del stage1
    transformer_cli(dev, timings, paths, scene, work)

    # the JAX defaults
    dv = Variant("defaults", make_model_cfg(), dtype=None)
    print(f"defaults config: encoder {dv.cfg.encoder}, {dv.cfg.rendering.pixel_feature_mode} "
          f"features, fused trunks {dv.cfg.rendering.use_fused_trunk}, float32")
    model = build_model(dev, None, cfg=dv.cfg, dtype=None)
    _, paths["defaults_serve"] = render_vs_eager(
        dev, model, "defaults", render_all(model),
        all_zero_but({"K6-fwd": 2, "K5": n, "K1-fwd": 2 * n}), 24, timings, "defaults_")
    del model
    free()
    want = stage1_counts("exact", conv=None, trunks=False)
    model, state, batch, g = train_setup(dev, "exact", variant=dv)
    counts = gate_counts(state, batch, g, "defaults train", want)
    enc = [(k, p.grad) for k, p in model.named_parameters() if k.startswith("encoder.")]
    bad = [k for k, gr in enc if gr is None or not bool(torch.isfinite(gr).all())
           or not bool(gr.abs().sum() > 0)]
    norms = [k for k, _ in enc if ".bn" in k or "_norm." in k]
    print(f"defaults train: {len(enc) - len(bad)}/{len(enc)} encoder parameters with a finite "
          f"non-zero gradient after an update step, {len(norms)} of them GroupNorm scales and "
          f"biases; {bad[:4]}")
    check(enc and not bad and norms, "defaults train: an encoder gradient is missing or not "
                                     "finite")
    # one update step, captured against five eager runs by the phase-5 rule
    # on its metrics and its parameter gradients, not on the state after
    # Adam: a first Adam step moves each element by about lr times the sign
    # of its gradient, so a tensor that cuDNN's, max-pool's, upsampling's and
    # the gathers' atomic sums make differ from run to run can still repeat
    # by chance over five runs after it (a GroupNorm scale did so on the
    # card), while its gradient differs in every run
    plan = [(True, *step_randomness(state, batch, g))]
    snap = snapshot(state)

    def metrics_and_grads(st):
        names, values = run_steps(st, batch, plan)
        named = [(n, v) for n, v in zip(names, values) if n.startswith("step ")]
        named += [(f"grad {n}", p.grad.detach().cpu().clone())
                  for n, p in st.model.named_parameters()]
        return [n for n, _ in named], [v for _, v in named]

    eager = []
    with model.programs.eager():
        for _ in range(5):
            names, record = metrics_and_grads(state)
            eager.append(record)
            restore(state, snap)
        ops = ops_with_atomics(lambda: run_steps(state, batch, plan))
        restore(state, snap)
    del model, state
    free()
    model, state = new_train_state(dev, "exact", variant=dv)
    restore(state, snap)
    _, captured = metrics_and_grads(state)
    compare_captured("defaults train (metrics and gradients)", names, eager, captured, ops,
                     exact=True)
    counts.update(replay_counts(state, batch, g, "defaults train", want))
    update = make_train_step(model, state.cfg, static_updated=True)
    with model.programs.eager():
        eager_ms = median_step_ms(lambda: update(state, batch, generator=g), n=3)
    ms = median_step_ms(lambda: update(state, batch, generator=g), n=3)
    timings["defaults_train_update_step_ms"] = ms
    timings["defaults_train_eager_update_step_ms"] = eager_ms
    print(f"defaults train update step (batch {TRAIN_B} x {TRAIN_RAYS} rays, float32): captured "
          f"{ms:.2f} ms, eager {eager_ms:.2f} ms (medians of 3); {card_line()}")
    paths["defaults_train_update"] = counts["update"]
    paths["defaults_train_update_captured"] = counts["update captured"]
    del model, state, batch, update
    free()

    # flow_mlp
    fv = Variant("flow_mlp", yaml_model_cfg(*FLOW_MLP_OVERRIDES))
    model = build_model(dev, None, cfg=fv.cfg)
    hw = (32, PATCH // 32)  # one chunk of rays from the 480x640 context

    def chunk():
        return render_camera(model, cam, robot, Z_NEAR, Z_FAR, *hw, patch_size=PATCH)

    _, paths["flow_mlp_serve"] = render_vs_eager(
        dev, model, "flow_mlp", chunk,
        all_zero_but({"K9-fwd": 24, "K6-fwd": 3, "K5": 1, "K7-tz-fwd": 2}),
        fv.cfg.action_decoder.mlp.n_blocks * fv.cfg.action_decoder.mlp.d_hidden, timings,
        "flow_mlp_", hw=hw)
    ri = RenderingInput(origins=torch.zeros((1, 16, 3), device=dev),
                        directions=torch.ones((1, 16, 3), device=dev) / math.sqrt(3.0),
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    try:
        model.encode_image(cam, ri, robot)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    print(f"flow_mlp encode_image refused: {refused!r}")
    check(refused is not None and "nonlinear" in refused, "flow_mlp: encode_image did not raise")
    del model
    free()
    counts = variant_action_steps(dev, fv, all_zero_but(STAGE2_FORWARD_ONLY), timings)
    paths["flow_mlp_action"] = counts["update"]
    paths["flow_mlp_action_captured"] = counts["update captured"]


# ----------------------------------------------------------------- phase 11

# RAFT: a 9-frame 480x640 video, 8 pairs in one chunk; the float64 check's
# tolerance on one pair (relative to the float64 flow's largest component):
# on an H100 float32 reads 2.7e-6 to 3.3e-6 and the same pair under cuDNN's
# TF32 2.3e-3, so 1e-4 passes the one and refuses the other with ~20x room
# on each side
RAFT_FRAMES, RAFT_CHUNK, RAFT_F64_TOL = 9, 8, 1e-4


def fabricate_raft_large(seed=SEED) -> dict:
    """A torchvision raft_large state_dict (its names and shapes) drawn with
    seeded numpy: convolution kernels N(0, 1 / fan_in), biases N(0, 0.01),
    the context encoder's BatchNorms near the identity with their
    num_batches_tracked counters; the feature encoder's instance norms have
    no tensors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, kh, kw):
        sd[f"{name}.weight"] = rng.normal(0, 1 / math.sqrt(cin * kh * kw), (cout, cin, kh, kw))
        sd[f"{name}.bias"] = rng.normal(0, 0.01, cout)

    def bn(name, c):
        sd[f"{name}.weight"] = 1 + rng.normal(0, 0.1, c)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.num_batches_tracked"] = np.asarray(1000)

    for enc, batch in (("feature_encoder", False), ("context_encoder", True)):
        conv(f"{enc}.convnormrelu.0", 64, 3, 7, 7)
        if batch:
            bn(f"{enc}.convnormrelu.1", 64)
        cin = 64
        for li, (ch, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            for bi in range(2):
                base = f"{enc}.layer{li}.{bi}"
                inp = cin if bi == 0 else ch
                conv(f"{base}.convnormrelu1.0", ch, inp, 3, 3)
                conv(f"{base}.convnormrelu2.0", ch, ch, 3, 3)
                if batch:
                    bn(f"{base}.convnormrelu1.1", ch)
                    bn(f"{base}.convnormrelu2.1", ch)
                if bi == 0 and (stride != 1 or inp != ch):
                    conv(f"{base}.downsample.0", ch, inp, 1, 1)
                    if batch:
                        bn(f"{base}.downsample.1", ch)
            cin = ch
        conv(f"{enc}.conv", 256, 128, 1, 1)
    me = "update_block.motion_encoder"
    conv(f"{me}.convcorr1.0", 256, 4 * 81, 1, 1)
    conv(f"{me}.convcorr2.0", 192, 256, 3, 3)
    conv(f"{me}.convflow1.0", 128, 2, 7, 7)
    conv(f"{me}.convflow2.0", 64, 128, 3, 3)
    conv(f"{me}.conv.0", 126, 256, 3, 3)
    for i, (kh, kw) in ((1, (1, 5)), (2, (5, 1))):
        for gate in ("convz", "convr", "convq"):
            conv(f"update_block.recurrent_block.convgru{i}.{gate}", 128, 384, kh, kw)
    conv("update_block.flow_head.conv1", 256, 128, 3, 3)
    conv("update_block.flow_head.conv2", 2, 256, 3, 3)
    conv("mask_predictor.convrelu.0", 256, 128, 3, 3)
    conv("mask_predictor.conv", 64 * 9, 256, 1, 1)
    return {k: torch.from_numpy(np.asarray(v, np.int64 if k.endswith("tracked") else np.float32))
            for k, v in sd.items()}


def _reference_fc(name: str) -> str:
    """A ResnetFC submodule's port name -> the reference repo's."""
    if name.startswith("lin_z_"):
        return "lin_z." + name.split("_")[-1]
    if name.startswith("blocks_"):
        _, n, fc, m = name.split("_")
        return f"blocks.{n}.{fc}_{m}"
    return name


def reference_name(key: str) -> str:
    """A port state-dict key -> the reference checkpoint's key (the inverse
    of port_reference_checkpoint's name map)."""
    *mods, leaf = key.split(".")
    if mods[0] == "encoder":
        if mods[1].startswith("layer"):
            layer, block = mods[1].split("_block")
            sub = {"downsample_conv": "downsample.0",
                   "downsample_norm": "downsample.1"}.get(mods[2], mods[2])
            mods = ["encoder", "model", layer, block, sub]
        else:
            mods = ["encoder", "model", mods[1]]
    elif mods[0].startswith("proposal_networks_"):
        mods = ["proposal_networks", mods[0].split("_")[-1], mods[1],
                _reference_fc(mods[2])]
    elif mods[0] == "decoder" and len(mods) > 1:  # not a bare parameter
        head = mods[1]
        if head == "color_head":
            mods = ["decoder", "color_head", {"fc1": "0", "fc2": "2", "fc3": "4"}[mods[2]]]
        elif len(mods) == 3:
            mods = ["decoder", head, _reference_fc(mods[2])]
    return "model." + ".".join(mods + [leaf])


def fabricate_reference_flagship(model, seed=SEED) -> dict:
    """A reference Lightning checkpoint's state_dict at `model`'s widths
    (names and layouts of the reference repo, utils/port_torch.py), drawn
    with seeded numpy: kaiming-normal linears and convolutions (the Jacobian
    head's at a hundredth, so that the warped points stay in front of the
    camera), biases N(0, 0.01), BatchNorms near the identity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(("running_mean", "bias")) or key.endswith("embedding"):
            v = rng.normal(0, 0.01, shape)
        elif t.dim() == 1:  # a norm's scale
            v = 1 + rng.normal(0, 0.1, shape)
        else:
            fan_in = shape[1] if t.dim() == 2 else shape[0] * shape[1] * shape[2]
            v = rng.normal(0, math.sqrt(2 / fan_in), shape)
            if ".jacobian_head." in f".{key}":
                v *= 0.01
            if t.dim() == 4:  # the port's HWIO -> the reference's [out, in, kh, kw]
                v = v.transpose(3, 2, 0, 1)
        sd[reference_name(key)] = np.ascontiguousarray(v, dtype=np.float32)
    return sd


def raft_video(dev):
    """[RAFT_FRAMES, 480, 640, 3] in [0, 1] on the card: a seeded low-frequency
    texture (64x86 noise, bicubic upsampled) drifting 3 px right and 1 px
    down per frame."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    frames = RAFT_FRAMES
    rng = np.random.default_rng(SEED + 21)
    noise = torch.from_numpy(rng.uniform(size=(1, 3, 64, 86)).astype(np.float32))
    big = F.interpolate(noise, size=(H + frames, W + 3 * frames), mode="bicubic",
                        align_corners=False).clamp(0, 1)[0].permute(1, 2, 0)
    return torch.stack([big[frames - i:frames - i + H, 3 * (frames - i):3 * (frames - i) + W]
                        for i in range(frames)]).contiguous().to(dev)


def tools_phase(dev, timings, paths, work):
    """Phase 11: the inference toolbox and the flow helper (lines "tools",
    "raft"). Returns nothing; every gate raises."""
    tools_load_model(dev, timings, paths, work)
    tools_reference_checkpoint(dev, timings, paths)
    flow, video = raft_phase(dev, timings)
    tools_overlays(flow, video)


def tools_load_model(dev, timings, paths, work):
    """load_model on phase 8's stage-2 checkpoint (its overrides, bf16): the
    state bit for bit the file's; a camera json written from phase 8's
    scene through parse_camera_json; a 480x640 render through the captured
    programs (counted through replay) and its joint-sensitivity map."""
    import json as _json

    import numpy as np
    import torch

    from neural_jacobian_field_torch.config import CONFIG_DIR
    from neural_jacobian_field_torch.data import image_io
    from neural_jacobian_field_torch.inference import (
        JACOBIAN_COLORMAP, compute_joint_sensitivity, load_model, parse_camera_json,
        visualize_joint_sensitivity)
    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import CameraInput, RobotInput
    from neural_jacobian_field_torch.ops import kernels as K

    scene = work / "scene"
    ckpt_dir = work / "ck2"
    overrides = [*cli_overrides(scene, work), "dataset.mode=action"]
    peak_window(dev)
    t0 = time.perf_counter()
    model = load_model(CONFIG_DIR, ckpt_dir, overrides, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    saved = torch.load(ckpt_dir / f"ckpt_{CLI_STEPS:09d}.pt", map_location="cpu",
                       weights_only=True)["model"]
    state = model.state_dict()
    differ = [k for k in saved if not torch.equal(state[k].cpu(), saved[k])]
    stats = sum(k.endswith(("running_mean", "running_var")) for k in saved)
    print(f"tools load_model: {CONFIG_DIR.name}/ + {len(overrides)} overrides, checkpoint "
          f"{ckpt_dir.name}/ckpt_{CLI_STEPS:09d}.pt, bf16, on {next(model.parameters()).device}, "
          f"eval mode {not model.training}: {load_s:.3f} s; {len(saved)} entries ({stats} "
          f"BatchNorm statistics) bit for bit the file's: {not differ and set(saved) == set(state)}")
    check(not differ and set(saved) == set(state) and not model.training,
          f"tools load_model: state differs from the checkpoint at {differ[:5]}")

    # the cameras through camera jsons written from the scene's transforms
    cams = _json.loads((scene / "transforms.json").read_text())["cameras"]
    parsed = []
    for name, c in (("ctxt", cams[0]), ("trgt", cams[1])):
        path = work / f"camera_{name}.json"
        path.write_text(_json.dumps(c))
        parsed.append(parse_camera_json(path))
    ctxt, trgt = parsed
    check((ctxt["height"], ctxt["width"]) == (H, W), f"tools camera json: {ctxt['height']}x"
          f"{ctxt['width']}")
    image = image_io.read_image(scene / "rgb" / "view_0" / "00000_00000.png")[..., :3]
    image = torch.from_numpy(np.asarray(image, np.float32) / 255.0)[None].to(dev)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None].to(dev)  # noqa: E731
    cam = CameraInput(input_image=image, ctxt_extrinsics=as_t(ctxt["c2w"]),
                      ctxt_intrinsics=as_t(ctxt["intrinsics"]),
                      trgt_extrinsics=as_t(trgt["c2w"]), trgt_intrinsics=as_t(trgt["intrinsics"]))
    action = torch.from_numpy(np.random.default_rng(SEED + 5).normal(
        0, 0.3, (1, model.cfg.action_dim)).astype(np.float32)).to(dev)
    robot = RobotInput(robot_action=action)

    def render():
        return render_camera(model, cam, robot, Z_NEAR, Z_FAR, trgt["height"], trgt["width"],
                             patch_size=PATCH)

    t0 = time.perf_counter()
    render()  # captures the encoder's and the chunk's programs
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    counts = K.launch_counts()
    check_no_legacy("tools load_model render")
    paths["tools_load_model"] = counts
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n = H * W // PATCH
    want = all_zero_but({"K9-fwd": 24, "K6-fwd": 2 + n, "K5": n, "K7-tz-fwd": 3 * n})
    print(f"tools render {H}x{W} of the loaded model (camera json, captured programs): "
          f"{render_s:.3f} s ({H * W / render_s:.1f} rays/s), first call with the captures "
          f"{capture_s:.3f} s, peak {peak:.2f} GiB; launches {counts}")
    check(counts == want, f"tools render launches {counts} != {want}")
    af = out.action_features
    check(tuple(af.shape) == (1, H, W, 24) and bool(torch.isfinite(af).all()),
          f"tools action_features {tuple(af.shape)} or not finite")

    t0 = time.perf_counter()
    sens = compute_joint_sensitivity(af)
    sens_s = time.perf_counter() - t0
    palette = np.asarray(JACOBIAN_COLORMAP["model_allegro"]).T
    img = visualize_joint_sensitivity(sens[0], palette)
    print(f"tools joint sensitivity: {sens.shape} in [{sens.min():.4f}, {sens.max():.4f}] "
          f"({sens_s * 1e3:.1f} ms on the host, the copy included); image {img.shape} "
          f"{img.dtype}, mean {img.mean():.2f}")
    check(sens.shape == (1, 8, H, W) and np.isfinite(sens).all() and sens.min() >= 0
          and sens.max() <= 1, "tools sensitivity: shape, finiteness or range")
    check(img.shape == (H, W, 3) and img.dtype == np.uint8, "tools sensitivity image")
    timings.update(tools_load_model_s=load_s, tools_render_s=render_s,
                   tools_render_peak_mem_gib=peak, tools_sensitivity_ms=sens_s * 1e3)
    del model, out
    gc.collect()
    torch.cuda.empty_cache()


def tools_reference_checkpoint(dev, timings, paths):
    """A reference checkpoint fabricated at the flagship's widths (exact
    mode, jacobian_mlp, action_dim 8), ported with port_reference_checkpoint
    and loaded with strict=True; one 2048-ray chunk rendered eagerly from a
    480x640 context image."""
    import torch

    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg
    from neural_jacobian_field_torch.ops import kernels as K
    from neural_jacobian_field_torch.utils.port_torch import is_stat, port_reference_checkpoint

    model = Model(flagship_model_cfg(pixel_feature_mode="exact"), compute_dtype=torch.bfloat16)
    sd = fabricate_reference_flagship(model)
    t0 = time.perf_counter()
    ported = port_reference_checkpoint(sd)
    model.load_state_dict(ported, strict=True)
    port_s = time.perf_counter() - t0
    model.to(dev).eval()
    print(f"tools reference checkpoint: {len(sd)} reference tensors -> {len(ported)} entries "
          f"({sum(map(is_stat, ported))} BatchNorm statistics), loaded with strict=True in "
          f"{port_s:.3f} s")
    cam, robot = cameras(dev)
    with model.programs.eager():
        K.reset_launch_counts()
        out = render_camera(model, cam, robot, Z_NEAR, Z_FAR, 32, 64, patch_size=PATCH)
        torch.cuda.synchronize()
        counts = K.launch_counts()
    check_no_legacy("tools reference chunk")
    paths["tools_reference"] = counts
    want = all_zero_but({"K9-fwd": 24, "K6-fwd": 2, "K5": 1, "K7-fwd": 3, "K1-fwd": 2})
    finite = all(bool(torch.isfinite(t).all()) for t in outputs_of(out))
    print(f"tools reference chunk (exact, 32x64 = {PATCH} rays from a {H}x{W} context): "
          f"finite {finite}, rgb [{float(out.rgb.min()):.4f}, {float(out.rgb.max()):.4f}], "
          f"depth [{float(out.depth_raw.min()):.4f}, {float(out.depth_raw.max()):.4f}]; "
          f"launches {counts}")
    check(finite, "tools reference chunk: non-finite outputs")
    check(counts == want, f"tools reference chunk launches {counts} != {want}")
    timings["tools_reference_port_s"] = port_s
    del model, out
    gc.collect()
    torch.cuda.empty_cache()


def raft_phase(dev, timings):
    """RAFT at raft_large's widths from a fabricated torchvision state dict:
    compute_video_flow forward and backward on a 9-frame 480x640 video
    (float32, TF32 off), twice, bit for bit; one pair against the module in
    float64, in float32 (within the tolerance) and under cuDNN's TF32
    (beyond it); ms per pair, peak memory, the operations per pair (counted by
    torch's FlopCounterMode on that pair); ms per pair again with cuDNN's
    TF32 and with the bf16 module. Returns the forward flow and the video."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from neural_jacobian_field_torch.flow import (
        RAFT, compute_video_flow, load_torch_raft_state_dict)

    sd = fabricate_raft_large()
    raft = RAFT(num_iters=20)
    unused = []
    ported = load_torch_raft_state_dict(raft, sd, unused_out=unused)
    state = raft.state_dict()
    print(f"raft raft_large from a fabricated torchvision state dict: {len(sd)} tensors, "
          f"{len(ported)} module entries of {len(state)} ported, unused {unused}; "
          f"{sum(p.numel() for p in raft.parameters())} parameters")
    check(not unused and set(ported) == set(state), "raft: the loader left tensors or entries")
    raft.eval()
    video = raft_video(dev)
    pairs = RAFT_FRAMES - 1

    peak_window(dev)
    t0 = time.perf_counter()
    fwd = compute_video_flow(raft, video, chunk=RAFT_CHUNK)
    bwd = compute_video_flow(raft, video, chunk=RAFT_CHUNK, backward=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    fwd2 = compute_video_flow(raft, video, chunk=RAFT_CHUNK)
    bwd2 = compute_video_flow(raft, video, chunk=RAFT_CHUNK, backward=True)
    same = bool(torch.equal(fwd, fwd2)) and bool(torch.equal(bwd, bwd2))
    finite = bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(bwd).all())
    shape = (pairs, H, W, 2)
    print(f"raft compute_video_flow {RAFT_FRAMES} frames {H}x{W}, chunk {RAFT_CHUNK}: forward "
          f"{tuple(fwd.shape)}, backward {tuple(bwd.shape)}, finite {finite}, two runs bit "
          f"for bit {same}; median |flow| forward {float(fwd.norm(dim=-1).median()):.3f} px, "
          f"mean flow ({float(fwd[..., 0].mean()):.3f}, {float(fwd[..., 1].mean()):.3f}) px "
          f"(random weights: no relation to the video's 3 px, 1 px drift)")
    check(tuple(fwd.shape) == shape and tuple(bwd.shape) == shape, "raft: flow shapes")
    check(finite and same, "raft: flow not finite, or two runs differ")

    ms = cuda_time_ms(lambda: compute_video_flow(raft, video, chunk=RAFT_CHUNK), reps=3,
                      warmup=0) / pairs
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            one = raft(video[:1], video[1:2])
    flops = fc.get_total_flops()
    by_op = {str(k).split(".")[-1]: v / 1e9 for k, v in fc.get_flop_counts()["Global"].items()}
    print(f"raft {ms:.3f} ms per pair (CUDA events, median of 3 runs of {pairs} pairs in one "
          f"chunk, float32, TF32 off), peak {peak:.3f} GiB allocated (forward and backward "
          f"runs); {flops / 1e12:.4f} TFLOP per pair (FlopCounterMode: "
          + ", ".join(f"{k} {v:.1f} GFLOP" for k, v in by_op.items())
          + f"), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; the first forward and "
          f"backward run {first_s:.3f} s; {card_line()}")

    # the same pairs as a user would run them: cuDNN with TF32 (PyTorch's
    # default; the flag restored after) and the bf16 module (JAX's float32
    # pins); without TF32 cuDNN's heuristic takes an FFT algorithm for
    # float32 (on an H100, 80% of RAFT's device time in its complex GEMMs)
    torch.backends.cudnn.allow_tf32 = True
    try:
        ms_tf32 = cuda_time_ms(lambda: compute_video_flow(raft, video, chunk=RAFT_CHUNK),
                               reps=3, warmup=1) / pairs
        with torch.no_grad():
            one_tf32 = raft(video[:1], video[1:2])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    raft16 = RAFT(num_iters=20, dtype=torch.bfloat16)
    raft16.load_state_dict(raft.state_dict())
    peak_window(dev)
    flow16 = compute_video_flow(raft16.eval(), video, chunk=RAFT_CHUNK)
    peak16 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms16 = cuda_time_ms(lambda: compute_video_flow(raft16, video, chunk=RAFT_CHUNK), reps=3,
                        warmup=0) / pairs
    dev16 = float((flow16 - fwd).norm(dim=-1).median())
    print(f"raft as a user runs it: cuDNN with TF32 {ms_tf32:.3f} ms per pair "
          f"({flops / (ms_tf32 * 1e-3) / 1e12:.2f} TFLOP/s); dtype=bfloat16 {ms16:.3f} ms per "
          f"pair, peak {peak16:.3f} GiB, flow {flow16.dtype} finite "
          f"{bool(torch.isfinite(flow16).all())}, median |bf16 - float32| {dev16:.3f} px")
    check(flow16.dtype == torch.float32 and bool(torch.isfinite(flow16).all()),
          "raft bf16: the flow is not float32 or not finite")
    del raft16, flow16

    raft64 = copy.deepcopy(raft).double()
    with torch.no_grad():
        ref = raft64(video[:1].double(), video[1:2].double())
    err, pair_err, tf32_err = (float((x.double() - ref).abs().max() / ref.abs().max())
                               for x in (one, fwd[:1], one_tf32))
    print(f"raft float32 against float64 (the same module and pair): max |err| / max |flow| "
          f"{err:.3e} alone, {pair_err:.3e} in the {RAFT_CHUNK}-pair chunk, {tf32_err:.3e} "
          f"alone with cuDNN's TF32 (tolerance {RAFT_F64_TOL:.0e}: float32 within it, TF32 "
          f"beyond it); max |flow| {float(ref.abs().max()):.3f} px")
    check(err <= RAFT_F64_TOL and pair_err <= RAFT_F64_TOL,
          f"raft float32 vs float64: {err:.3e} / {pair_err:.3e} > {RAFT_F64_TOL:.0e}")
    check(tf32_err > RAFT_F64_TOL,
          f"raft: the float64 check does not see cuDNN's TF32 ({tf32_err:.3e} <= "
          f"{RAFT_F64_TOL:.0e})")
    timings.update(raft_ms_per_pair=ms, raft_peak_mem_gib=peak, raft_tflop_per_pair=flops / 1e12,
                   raft_f64_rel_err=max(err, pair_err), raft_tf32_f64_rel_err=tf32_err,
                   raft_tf32_ms_per_pair=ms_tf32,
                   raft_bf16_ms_per_pair=ms16, raft_bf16_peak_mem_gib=peak16)
    del raft, raft64
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, video


def tools_overlays(flow, video):
    """draw_pixel_motion of the RAFT flow where cv2 is installed; a line
    saying so where it is not (nothing depends on the overlays)."""
    import importlib.util

    import numpy as np

    if importlib.util.find_spec("cv2") is None:
        print("tools overlays: cv2 is not installed; no overlay drawn")
        return
    from neural_jacobian_field_torch.visualization import draw_pixel_motion

    yx = np.stack(np.meshgrid(np.arange(20, H, 40), np.arange(20, W, 40), indexing="ij"),
                  -1).reshape(-1, 2)
    motion = flow[0].cpu().numpy()[yx[:, 0], yx[:, 1]]
    img = draw_pixel_motion(video[0].cpu().numpy(), yx, motion)
    print(f"tools overlays: cv2 present; draw_pixel_motion of {len(yx)} RAFT flow vectors: "
          f"{img.shape} {img.dtype}")
    check(img.shape == (H, W, 3) and img.dtype == np.uint8, "tools overlay shape or dtype")


# ----------------------------------------------------------------- phase 13

# the 2D family at full width: 252x252 (configurations2d/dataset/
# left_finger.yaml's new_H / new_W: divisible by the ViT's 14 and by
# 2^(depth - 1)), batch 12 (configurations2d/config.yaml), float32
HW_2D, B_2D, STEPS_2D, CLI_STEPS_2D, CONTROL_ITERS_2D = 252, 12, 3, 60, 20
# the model-level checks' optimizer: a short warm-up so that 20 steps move
# the loss (the YAML's 10,000-step warm-up runs in the CLI part)
OPTIM_2D = dict(lr=1e-3, weight_decay=1e-5, warm_up_steps=5)
# float32 (TF32 off) against float64 gradients: the CPU tests' float32 bound
GRAD_TOL_2D = 1e-5


def model_2d(dev, name, dtype=None):
    """The configuration the YAML builds: unet (wrapper/pusher_only: depth 3,
    32 filters) or transformer (wrapper/left_finger: ViT-S/14 and a depth-3
    UNet decoder on 387 channels), command_dim 2, seeded weights."""
    import torch

    from neural_jacobian_field_torch.jacobian2d import (
        TransformerJacobianFieldCfg, UnetJacobianFieldCfg, get_model)

    cfg = UnetJacobianFieldCfg() if name == "unet" else TransformerJacobianFieldCfg()
    model = get_model(cfg).init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=dev, dtype=dtype or torch.float32)


def batch_2d(dev, seed):
    """A seeded batch: images in [0, 1], commands and target flows N(0, 1)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b = B_2D
    return {"input_frame_curr": torch.rand((b, HW_2D, HW_2D, 3), generator=g, device=dev),
            "input_command": torch.randn((b, 2), generator=g, device=dev),
            "trgt_flow_curr": torch.randn((b, HW_2D, HW_2D, 2), generator=g, device=dev)}


def snapshot_2d(state) -> dict:
    return dict(model=to_cpu(state.model.state_dict()), opt=to_cpu(state.optimizer.state_dict()),
                step=state.step)


def restore_2d(state, snap) -> None:
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["opt"])
    state.step = snap["step"]


def run_steps_2d(state, step, batches):
    """The batches' steps through `step`; (names, host copies) of each
    step's loss, then of `state_record` (parameters, Adam's state)."""
    import torch

    names, out = [], []
    for i, b in enumerate(batches):
        names.append(f"step {i} train/loss")
        out.append(step(state, b)["train/loss"].cpu())
    torch.cuda.synchronize()
    rec_names, rec = state_record(state)
    return names + rec_names, out + rec


class UNetDecisions:
    """The UNet's nonlinear decisions, recorded from one run (ReLU masks,
    2x2 pool choices, in call order) or replayed in another: replayed, a
    ReLU multiplies by the recorded mask and a pool reads the recorded
    window element, so that a float64 run computes the gradient of the
    float32 run's piecewise-linear function."""

    def __init__(self, replay=None):
        self.replay, self.taken = replay, []

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from neural_jacobian_field_torch.jacobian2d import unet

        self.saved = (torch.relu, unet.max_pool_2x2)
        max_pool_2x2 = unet.max_pool_2x2
        relu = torch.relu
        it = iter(self.replay or ())

        def relu_(x):
            if self.replay is not None:
                return x * next(it).to(x.dtype)
            self.taken.append(x > 0)
            return relu(x)

        def pool_(x):
            if self.replay is not None:
                idx = next(it)
                b, ho, wo, c = idx.shape
                flat = x.permute(0, 3, 1, 2).reshape(b, c, -1)
                y = flat.gather(2, idx.permute(0, 3, 1, 2).reshape(b, c, -1))
                return y.reshape(b, c, ho, wo).permute(0, 2, 3, 1)
            _, idx = F.max_pool2d(x.detach().permute(0, 3, 1, 2), 2, stride=2,
                                  return_indices=True)
            self.taken.append(idx.permute(0, 2, 3, 1))
            return max_pool_2x2(x)

        torch.relu, unet.max_pool_2x2 = relu_, pool_
        return self

    def __exit__(self, *exc):
        import torch

        from neural_jacobian_field_torch.jacobian2d import unet

        torch.relu, unet.max_pool_2x2 = self.saved
        return False


def twod_model_checks(dev, timings, name):
    """One 2D model at full width (lines "2d <name>")."""
    import torch

    from neural_jacobian_field_torch.jacobian2d import predict_2d
    from neural_jacobian_field_torch.jacobian2d.train import (
        Train2DCfg, create_train_state_2d, make_train_step_2d)

    label, cfg = f"2d {name}", Train2DCfg(**OPTIM_2D)
    model = model_2d(dev, name)
    n_params = sum(p.numel() for p in model.parameters())
    batches = [batch_2d(dev, SEED + 20 + i) for i in range(STEPS_2D)]
    img, cmd = batches[0]["input_frame_curr"], batches[0]["input_command"]
    state = create_train_state_2d(model, cfg)
    with model.programs.eager():
        want = predict_2d(model, img, cmd)
    t0 = time.perf_counter()
    got = predict_2d(model, img, cmd)  # captures
    capture_s = time.perf_counter() - t0
    again = predict_2d(model, img, cmd)
    same = all(bool(torch.equal(a, b)) and bool(torch.equal(a, c))
               for a, b, c in zip(want, got, again))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    print(f"{label}: {n_params / 1e6:.2f}M parameters; jacobian {tuple(got.jacobian.shape)} and "
          f"flow {tuple(got.flow.shape)} at {B_2D}x{HW_2D}x{HW_2D}, float32: captured (in "
          f"{capture_s:.2f} s) == eager bit for bit and two replays identical: {same}; "
          f"finite {finite}")
    check(same and finite and got.jacobian.shape == (B_2D, HW_2D, HW_2D, 4),
          f"{label}: the captured Jacobian map or flow differs from eager, or is not finite")

    # three train steps captured against five eager runs from one state
    step = make_train_step_2d(model, cfg)
    snap = snapshot_2d(state)
    eager = []
    with model.programs.eager():
        for _ in range(5):
            names, rec = run_steps_2d(state, step, batches)
            eager.append(rec)
            restore_2d(state, snap)
        ops = ops_with_atomics(lambda: step(state, batches[0]))
        restore_2d(state, snap)
    model2 = model_2d(dev, name)
    state2 = create_train_state_2d(model2, cfg)
    restore_2d(state2, snap)
    step2 = make_train_step_2d(model2, cfg)
    _, captured = run_steps_2d(state2, step2, batches)
    compare_captured(f"{label} train", names, eager, captured, ops, exact=True)
    del model, state, step, eager
    gc.collect()
    torch.cuda.empty_cache()

    # replayed step time, steps/s, peak memory
    peak_window(dev)
    ms = median_step_ms(lambda: step2(state2, batches[0]), n=10)
    alloc, reserved = peaks_gib(dev)
    timings[f"2d_{name}_step_ms"] = ms
    timings[f"2d_{name}_steps_per_s"] = 1e3 / ms
    timings[f"2d_{name}_peak_mem_gib"] = alloc
    print(f"{label} captured train step (batch {B_2D}, {HW_2D}x{HW_2D}, float32, TF32 off): "
          f"{ms:.2f} ms (median of 10 replays), {1e3 / ms:.1f} steps/s, "
          f"{B_2D * 1e3 / ms:.1f} images/s; peak {alloc:.2f} GiB allocated, {reserved:.2f} "
          f"reserved; {card_line()}")

    # the loss falls over 20 captured steps on one batch; dino stays
    dino0 = {k: v.detach().clone() for k, v in model2.state_dict().items()
             if k.startswith("dino.")}
    losses = [float(step2(state2, batches[0])["train/loss"]) for _ in range(LOSS_STEPS)]
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    print(f"{label} loss over {LOSS_STEPS} captured steps on one batch: {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; mean of the first 3 {first:.5f}, of the last 3 {last:.5f} "
          f"(bound: finite, last < first)")
    check(all(math.isfinite(v) for v in losses) and last < first, f"{label}: the loss did not fall")
    if dino0:
        frozen = all(torch.equal(v, model2.state_dict()[k]) for k, v in dino0.items())
        print(f"{label}: {len(dino0)} dino tensors bit for bit unchanged after "
              f"{state2.step} steps: {frozen}; {len(state2.frozen)} frozen parameters, none "
              f"held by Adam")
        check(frozen and len(state2.frozen) == len(dino0), f"{label}: a dino parameter moved")
    del state2, step2
    gc.collect()
    torch.cuda.empty_cache()

    # one step's gradients in float32 (TF32 off) against float64. The ViT
    # takes no gradient: its float32 features are held to float64's, then
    # both decoders start from the float32 ones; the float64 run takes the
    # float32 run's ReLU masks and pool choices (UNetDecisions), as a
    # pre-activation within float32's rounding of zero flips its ReLU, which
    # moves a bias gradient summed over 762k pixels by ~1e-3 a flip
    from neural_jacobian_field_torch.jacobian2d.models import _flow_from_jacobian

    m64 = model_2d(dev, name, torch.float64)
    m64.load_state_dict(model2.state_dict())
    b = batches[1]
    feats = None
    if name == "transformer":
        with torch.no_grad():
            feats = model2.get_features(b["input_frame_curr"])
            f64 = m64.get_features(b["input_frame_curr"].double())
        feat_err = rel_err(feats, f64)
        print(f"{label} ViT-S/14 features, float32 against float64: {feat_err:.3e} of scale "
              f"(bound {GRAD_TOL_2D:.0e})")
        check(feat_err <= GRAD_TOL_2D, f"{label}: float32 ViT features off float64's")

    def grads(m, decisions):
        m.zero_grad(set_to_none=True)
        dt = next(m.parameters()).dtype
        img, cmd = b["input_frame_curr"].to(dt), b["input_command"].to(dt)
        with decisions:
            if feats is None:
                flow = m(img, cmd).flow
            else:
                jac = m.decoder(torch.cat([img, feats.to(dt)], dim=-1))
                flow = _flow_from_jacobian(jac, cmd, m.cfg.spatial_dim)
        torch.mean((flow - b["trgt_flow_curr"].to(dt)) ** 2).backward()
        return {n: p.grad.double() for n, p in m.named_parameters() if p.grad is not None}

    record = UNetDecisions()
    g32 = grads(model2, record)
    g64 = grads(m64, UNetDecisions(replay=record.taken))
    names = sorted(g64)
    a, b = (torch.cat([g[n].flatten() for n in names]) for g in (g32, g64))
    rel_l2 = float((a - b).norm() / b.norm())
    worst = max((rel_err(g32[n], g64[n]), n) for n in names)
    print(f"{label} gradients, float32 (TF32 off) against float64 on the card: {len(names)} "
          f"tensors, relative l2 {rel_l2:.3e} (bound {GRAD_TOL_2D:.0e}); the worst tensor "
          f"{worst[0]:.3e} of its scale at {worst[1]} (a tensor whose sums over the "
          f"{B_2D}x{HW_2D}x{HW_2D} pixels cancel carries float32's accumulation error)")
    check(set(g32) == set(g64) and rel_l2 <= GRAD_TOL_2D,
          f"{label}: float32 gradients off float64's beyond {GRAD_TOL_2D}")
    del model2, m64, g32, g64
    gc.collect()
    torch.cuda.empty_cache()


def twod_cli(dev, timings, work):
    """train2d in process for pusher_only and left_finger (lines "2d cli"),
    60 steps each on synthetic trajectories written at 252x252 first (JAX's
    CLI would write 64x64 ones); the .npz loaded back bit for bit. Returns
    the pusher's params path."""
    import torch

    from neural_jacobian_field_torch import train2d
    from neural_jacobian_field_torch.jacobian2d import get_model, make_synthetic_trajectories

    out = {}
    for config, scene in (("pusher_only", "pusher"), ("left_finger", "planar_hand")):
        root = work / f"2d_{config}"
        t0 = time.perf_counter()
        make_synthetic_trajectories(root, num_trajs=8, num_steps=8, height=HW_2D, width=HW_2D,
                                    scene=scene)
        write_s = time.perf_counter() - t0
        lines = []
        t0 = time.perf_counter()
        state, path = train2d.main([f"dataset={config}", f"wrapper={config}",
                                    f"dataset.root={root}", f"training.max_steps={CLI_STEPS_2D}",
                                    f"checkpoint.out={work / f'2d_{config}.npz'}"],
                                   log=lines.append)
        run_s = time.perf_counter() - t0
        logged = [ln for ln in lines if ln.startswith("step ")]
        loss = float(logged[-1].split("=")[1].split()[0]) if logged else float("nan")
        loaded = train2d.load_params_2d(get_model(state.model.cfg), path).to(dev)
        same = all(torch.equal(p, state.model.state_dict()[k])
                   for k, p in loaded.state_dict().items())
        timings[f"2d_cli_{config}_s"] = run_s
        print(f"2d cli {config}: 8 trajectories of 8 frames at {HW_2D}x{HW_2D} written in "
              f"{write_s:.1f} s; {state.step} steps in {run_s:.1f} s; logged: {logged}; "
              f"{path.name} loaded back bit for bit: {same}")
        check(state.step == CLI_STEPS_2D and math.isfinite(loss) and same,
              f"2d cli {config}: steps, loss or the .npz round trip")
        out[config] = path
        del state, loaded
        gc.collect()
        torch.cuda.empty_cache()
    return out["pusher_only"]


def twod_control(dev, params):
    """Tutorial 3's closed loop, 20 steps, on the CLI's trained pusher in the
    252x252 square world (lines "2d control")."""
    import numpy as np

    from neural_jacobian_field_torch.jacobian2d import UnetJacobianField, UnetJacobianFieldCfg
    from neural_jacobian_field_torch.train2d import load_params_2d
    from neural_jacobian_field_torch.tutorials.tutorial_3_control_demo import (
        SyntheticSquareEnv, closed_loop)

    model = load_params_2d(UnetJacobianField(UnetJacobianFieldCfg()), params).to(dev).eval()
    target = SyntheticSquareEnv(hw=HW_2D, half=4)
    target.q = np.array([0.5, -0.5])
    lines = []
    t0 = time.perf_counter()
    dists = closed_loop(model, SyntheticSquareEnv(hw=HW_2D, half=4), target,
                        CONTROL_ITERS_2D, log=lines.append)
    s = time.perf_counter() - t0
    print(f"2d control: {len(dists)} steps in {s:.2f} s ({s / len(dists) * 1e3:.1f} ms a "
          f"step); pixel error per step {[round(d, 1) for d in dists]}")
    check(all(math.isfinite(d) for d in dists), "2d control: a pixel error is not finite")


def twod_dinov2(dev, work):
    """The dinov2 ingest on a fabricated ViT-S/14 torch.hub state dict, on the
    card; its output loaded strict into a ViT-S/14 (lines "2d dinov2")."""
    import io
    import numpy as np
    import torch

    from neural_jacobian_field_torch import ingest
    from neural_jacobian_field_torch.jacobian2d import ViTCfg, ViTS14

    cfg, rng = ViTCfg(), np.random.default_rng(SEED)
    d, hid, p = cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.patch_size

    def r(*shape):
        return torch.from_numpy(rng.normal(scale=0.05, size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": r(d, 3, p, p), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, cfg.pos_grid ** 2 + 1, d),
          "mask_token": r(1, d), "norm.weight": 1 + r(d), "norm.bias": r(d)}
    for i in range(cfg.depth):
        for nm, shape in (("norm1", (d,)), ("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                          ("norm2", (d,)), ("mlp.fc1", (hid, d)), ("mlp.fc2", (d, hid))):
            sd[f"blocks.{i}.{nm}.weight"] = r(*shape)
            sd[f"blocks.{i}.{nm}.bias"] = r(shape[0])
        sd[f"blocks.{i}.ls1.gamma"], sd[f"blocks.{i}.ls2.gamma"] = r(d), r(d)
    path, out = work / "dinov2_vits14.pth", work / "dinov2_vits14.torch.pt"
    torch.save(sd, path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = ingest.main([str(path), "--eval", "--out", str(out)])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    vit = ViTS14()
    missing = vit.load_state_dict(torch.load(out, weights_only=True), strict=True)
    print(f"2d dinov2: ingest exit {code}; report {report}; loaded strict into ViTS14: "
          f"{not missing.missing_keys and not missing.unexpected_keys}")
    check(code == 0 and report["overwritten"] == report["total_leaves"] == 174
          and report["unused"] == 0 and report["eval"]["finite"],
          "2d dinov2: the ingest report is not a whole ViT-S/14")


def twod_phase(dev, timings, work):
    """Phase 13: the 2D Jacobian-field family at full width (lines "2d")."""
    for name in ("unet", "transformer"):
        twod_model_checks(dev, timings, name)
    params = twod_cli(dev, timings, work)
    twod_control(dev, params)
    twod_dinov2(dev, work)


def trace(fn):
    """torch.profiler around one fn() (ended by a synchronize): the profile,
    the traced wall time (the first host event to the last device event),
    the device's busy time (the union of its kernel, copy and set intervals,
    so overlapping work counts once), the device events in order, and
    {kernel name: [device us, launches]}; microseconds."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    host_start = min(e.time_range.start for e in events if e.device_type == DeviceType.CPU)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in dev_ev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    return prof, end - host_start, busy, dev_ev, by_name


def print_top(prefix, by_name, busy, top):
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{prefix}   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{n:<5d} {name[:90]}")


def profile_serve(dev, mode, top=12):
    """--profile serve [MODE]: torch.profiler around one 480x640 render and
    one 100-step Adam solve through their captured programs (after the
    captures), eager and captured: the traced wall time, the device's busy
    time and idle share, the number of device events and the top kernels."""
    import torch

    from neural_jacobian_field_torch.inference.action_opt import optimize_actions
    from neural_jacobian_field_torch.inference.render import camera_rays, render_camera
    from neural_jacobian_field_torch.models.model import RenderingInput, RobotInput

    model = build_model(dev, mode)
    cam, robot = cameras(dev)
    origins, dirs = camera_rays(H, W, cam.trgt_intrinsics, cam.trgt_extrinsics)
    pick = torch.randperm(H * W, generator=torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)[:ID_RAYS]
    ri = RenderingInput(origins=origins[:, pick], directions=dirs[:, pick],
                        z_near=torch.full((1,), Z_NEAR, device=dev),
                        z_far=torch.full((1,), Z_FAR, device=dev))
    enc = model.encode_image(cam, ri, robot)
    with torch.no_grad():
        target = model.infer_optical_flow(enc, cam, RobotInput(0.02 * robot.robot_action))
    action0 = torch.full((1, 8), 1e-3, device=dev)
    for label, fn in (
            ("render", lambda: render_camera(model, cam, robot, Z_NEAR, Z_FAR, H, W,
                                             patch_size=PATCH)),
            ("solve", lambda: optimize_actions(model, enc, cam, target, action0=action0,
                                               num_iters=100))):
        for kind, context in (("eager", model.programs.eager), ("captured",
                                                                contextlib.nullcontext)):
            with context():
                fn()  # warm-up, or the capture
                torch.cuda.synchronize()
                _, wall, busy, dev_ev, by_name = trace(fn)
            print(f"profile serve {mode} {label} {kind}: traced wall {wall / 1e3:.3f} ms, "
                  f"device busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall:.4f}, "
                  f"{len(dev_ev)} device events")
            print_top(f"profile serve {mode} {label} {kind}", by_name, busy, top)


def profile_train(dev, mode, top=15):
    """--profile: torch.profiler around one frozen and one update train step
    (after the warm-up) of stage 1 in the given feature mode, of stage 1
    under pallas_fused ("fused", epipolar), or of stage 2 ("action",
    epipolar, flow; its two steps differ in the proposal gate only), each
    eager and as a replay of its CUDA graph (captured before the trace),
    and in stage 1 one call of the 5-frozen + 1-update program. Per
    step: the traced wall time (the step's first host event to its last
    device event), the device's busy time (the union of its kernel, copy and
    set intervals, so overlapping work counts once), the idle share 1 - busy
    / wall, the number of device events, the device time under the
    optimizer step, the `top` kernels by device time, and the device time
    and launches by kernel of the stride-1 conv kernels (K9-fwd or K10,
    K9-dgrad, K9-wgrad and their ordered sums), the K7 trunks, K1-bwd and
    K5. "transformer" traces the stage-2 step of model_allegro_transformer
    (K9 convs) as "action" does, then `transformer_layers`."""
    import collections

    import torch

    from neural_jacobian_field_torch.training import (
        make_multi_train_step, make_train_step, stack_batches, train_step)

    if mode in ("action", "transformer"):
        variant = (Variant("transformer", yaml_model_cfg(*TRANSFORMER_OVERRIDES))
                   if mode == "transformer" else None)
        _, state, batch, g = action_setup(dev, "epipolar", "flow", variant=variant)
        for updated in (True, False):
            train_step(state, batch, g, updated)
    elif mode == "fused":
        _, state, batch, g = train_setup(dev, "epipolar", "pallas_fused")
    else:
        _, state, batch, g = train_setup(dev, mode)
    runs = []
    for kind, updated in (("frozen", False), ("update", True)):
        step = make_train_step(state.model, state.cfg, static_updated=updated)
        runs += [(kind, lambda u=updated: train_step(state, batch, g, u)),
                 (kind + " captured", lambda s=step: s(state, batch, generator=g))]
    if mode not in ("action", "transformer"):
        cycle = make_multi_train_step(state.model, state.cfg, 6,
                                      static_schedule=(False,) * 5 + (True,))
        stacked = stack_batches([batch] * 6)
        runs.append(("6-step program", lambda: cycle(state, stacked, generator=g)))
    for kind, fn in runs:
        fn()  # a warm-up, or the capture
        torch.cuda.synchronize()
        prof, wall, busy, dev_ev, by_name = trace(fn)
        opt_us = sum(getattr(a, "device_time_total", 0.0) for a in prof.key_averages()
                     if a.key.startswith("Optimizer.step"))
        print(f"profile {mode} {kind} step: traced wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.4f}, {len(dev_ev)} device "
              f"events, optimizer step {opt_us / 1e3:.3f} ms of device time")
        print_top(f"profile {mode} {kind}", by_name, busy, top)
        # the stride-1 conv kernels (K9-fwd / K10, K9-dgrad, K9-wgrad) and
        # their ordered-sum passes; the K7 trunk kernels (forward, the
        # backward's gradient chain, weight-gradient pass and ordered sums,
        # or the legacy ones); K1-bwd's stages, K1-bwd-upsample and
        # K1-bwd-small; K1-bwd-rows' bucket, block sort and block sums (the
        # row gathers' backward, a group of its own); K5
        for label, rx in (
                ("conv", r"(conv3x3_(tma|legacy)_kernel|wgrad_(tma|legacy)_kernel|"
                         r"stats_sum_kernel|sum_splits_kernel)(<[^>]*>)?"),
                ("K7", r"(field_mlp_(wg|fwd|bwd_chain|bwd|dw|dwz)_kernel|"
                       r"reduce_(bwd|partials|splits)_kernel)(<[^>]*>)?"),
                ("K1-bwd", r"(bucket_(count|scan|place)_kernel|segment_sum_kernel|"
                           r"merge_parts_kernel|upsample_bwd_kernel|small_scatter_kernel)"
                           r"(<[^>]*>)?"),
                ("K1-bwd-rows", r"rows_(bucket|sort|sum)_kernel(<[^>]*>)?"),
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
    if mode == "transformer":
        transformer_layers(state, batch)


def transformer_layers(state, batch):
    """The device time (torch.profiler, forward + backward) of each part of
    the transformer decoder's Jacobian at a stage-2 step's points (7 x 256
    rays x 256 samples): the query MLP (its [N, 575] float32 input built from
    random xyz and pixel-aligned features of the step's shapes), each of the
    attention layers and feed-forward blocks, and the float32 head; beside
    it the whole captured step's busy time from the traces above."""
    import torch

    from neural_jacobian_field_torch.models.transformer import dense

    dec = state.model.decoder
    dev = dec.jacobian_index_embedding.device
    tr = dec.jacobian_attn_decoder
    n = TRAIN_B * TRAIN_RAYS * state.model.cfg.rendering.num_nerf_samples
    g = torch.Generator(device=dev).manual_seed(SEED)
    query = torch.randn((n, dec.jacobian_query_mlp.in_features), generator=g, device=dev)
    x = dense(query, dec.jacobian_query_mlp, None).detach()
    z = dec.jacobian_index_embedding
    parts = [("query MLP", lambda: dense(query, dec.jacobian_query_mlp, None))]
    for i in range(tr.depth):
        attn, an = getattr(tr, f"layers_{i}_attn"), getattr(tr, f"layers_{i}_attn_norm")
        ff, fn_ = getattr(tr, f"layers_{i}_ff"), getattr(tr, f"layers_{i}_ff_norm")
        parts += [(f"layer {i} attention", lambda a=attn, m=an: x + a(m(x), z)),
                  (f"layer {i} feed-forward", lambda f=ff, m=fn_: x + f(m(x)))]
    parts.append(("head", lambda: dense(x, dec.jacobian_head, None)))
    total = 0.0
    for name, fn in parts:
        def fwd_bwd(fn=fn):
            out = fn()
            out.backward(torch.ones_like(out))
        ms = device_ms(fwd_bwd)
        total += ms
        print(f"profile transformer {name}: {ms:.3f} ms of device time, forward + backward, "
              f"N = {n}")
    print(f"profile transformer layers: {total:.3f} ms in all; {card_line()}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", nargs="*", metavar="WHAT",
                        help="only profile, with torch.profiler, one frozen and one update "
                             "train step of the given feature mode (epipolar, the default, or "
                             "exact), of the epipolar step under pallas_fused (fused) or of the "
                             "stage-2 step (action), or of the transformer model's stage-2 step "
                             "with the device time of each of its layers (transformer); "
                             "or, with 'serve [MODE]', one render and "
                             "one 100-step solve, eager and captured; and print where the "
                             "device time goes")
    parser.add_argument("--determinism", action="store_true",
                        help="only: the stage-1 steps' ops that warn under "
                             "torch.use_deterministic_algorithms, their ops with atomic sums, "
                             "whether their eager runs repeat bit for bit, and the 6-step "
                             "cycle's rays/s (determinism_report)")
    parser.add_argument("--torch-deterministic", action="store_true",
                        help="with --determinism: run it all under "
                             "torch.use_deterministic_algorithms(True)")
    args = parser.parse_args()
    profile = args.profile
    if profile is not None:
        serve = profile[:1] == ["serve"]
        what = (profile[1:] if serve else profile) or ["epipolar"]
        if len(what) != 1 or what[0] not in (MODES if serve else
                                                MODES + ("fused", "action", "transformer")):
            parser.error(f"--profile {' '.join(profile)}: expected [serve] MODE")
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
        if profile is not None:
            (profile_serve if serve else profile_train)(dev, what[0])
            return 0
        if args.determinism:
            failed = determinism_report(dev, torch_deterministic=args.torch_deterministic)
            print(f"determinism: paths whose eager steps differ or sum with atomics: "
                  f"{failed or 'none'}")
            return 1 if failed else 0

        phase_line(1, "card and build", t_start)
        t0 = time.perf_counter()
        rows = kernel_checks(dev)
        rows.update(k10_checks(dev))
        rows.update(backward_kernel_checks(dev))
        phase_line(2, "kernels against their plain versions", t0)
        timings, paths = {}, {}
        cam, robot = cameras(dev)
        for mode in MODES:
            t0 = time.perf_counter()
            model = build_model(dev, mode)
            paths[("" if mode == "epipolar" else "exact_") + "serve"] = serve_phase(
                dev, model, cam, robot, timings, mode)
            phase_line(3, f"serving {mode}", t0)
            t0 = time.perf_counter()
            inverse_dynamics_phase(dev, model, cam, robot, timings, mode)
            phase_line(4, f"inverse dynamics {mode}", t0)
            del model
            gc.collect()  # the model and its programs' cache refer to each other
            torch.cuda.empty_cache()
        timings["serve_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        for prefix, mode, conv_impl in (("", "epipolar", "pallas"), ("exact_", "exact", "pallas"),
                                        ("fused_", "epipolar", "pallas_fused")):
            t0 = time.perf_counter()
            counts, stage1 = train_phase(dev, timings, mode, conv_impl)
            for kind in ("update", "frozen"):
                paths[f"{prefix}train_{kind}"] = counts[kind]
                paths[f"{prefix}train_{kind}_captured"] = counts[kind + " captured"]
            phase_line(5, f"train {mode} {conv_impl}", t0)
        for mode, supervision in (("epipolar", "flow"), ("exact", "flow"),
                                  ("epipolar", "tracks")):
            t0 = time.perf_counter()
            name = "action_" + ("tracks" if supervision == "tracks" else mode + "_flow")
            counts = action_phase(dev, timings, mode, supervision, stage1)
            paths[name] = counts["update"]
            paths[name + "_captured"] = counts["update captured"]
            phase_line(6, f"action {mode} {supervision}", t0)
        del stage1
        t0 = time.perf_counter()
        concat_layout_checks(dev)
        phase_line(7, "concat layout", t0)
        with tempfile.TemporaryDirectory(prefix="njf_cli_") as work:
            t0 = time.perf_counter()
            scene = cli_phase(dev, timings, paths, Path(work))
            phase_line(8, "training CLI", t0)
            t0 = time.perf_counter()
            e2e_phase(dev, timings, paths)
            phase_line(9, "e2e drive", t0)
            t0 = time.perf_counter()
            other_decoders_phase(dev, timings, paths, cam, robot, scene, Path(work))
            phase_line(10, "other decoders and norms", t0)
            t0 = time.perf_counter()
            tools_phase(dev, timings, paths, Path(work))
            phase_line(11, "tools", t0)
            t0 = time.perf_counter()
            twod_phase(dev, timings, Path(work))
            phase_line(13, "2d family", t0)
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
