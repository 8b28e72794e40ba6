#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (from the repo root; needs one CUDA card)
    python3 chip_smoke.py --profile main|roi|batched|control|serving|lm|moe|zoo
                                                  (one profile)
    python3 chip_smoke.py --sharded   (phases 1, 2, the worker-thread
                  check and 6b' alone; on several cards, a mesh over them)
    python3 chip_smoke.py --train     (phases 1, 2 and 6e alone)
    python3 chip_smoke.py --seq-sum   (phase 1, the seq_sum build and its
                  checks and times of phase 3 alone)
    python3 chip_smoke.py --moe       (phases 1, 2, the flash_attention
                  sweep and [moe]'s two forms, and 7b alone)
    python3 chip_smoke.py --moe-sharded   (phases 1, 2 and 7b's
                  expert-parallel moe_block alone; on several cards, meshes
                  over them)
    python3 chip_smoke.py --zoo       (phases 1 and 7c alone)
    python3 chip_smoke.py --dryrun    (phases 1 and 7d alone)

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: name and power limit from nvidia-smi;
2. build: compiles the port's CUDA kernels (``src/repro_torch/kernels/csrc``)
   with nvcc, one process per source;
3. kernels: each kernel form (motion_sad exhaustive/diamond x f32/bf16,
   blockdct forward at the anchor and LR shapes and its inverse,
   and with a table a frame, seq_sum at the LR codec's grid and the
   anchors' of one stream and of nine (and, checked, not timed, at the
   (S, 1, T) grid, grids it streams in row or column tiles, odd and
   misaligned grids; then the time of one add of its chain), qtransfer
   f32 at the quality transfer's and the motion compensation's shapes
   and bf16, roi_gather, and nine flash_attention forms:
   llama3.2-1B's and chatglm3-6B's heads, a 1024 window, cross Sq != Sk,
   non-causal, ragged, f32 inputs, qwen2-moe's heads and mixtral's with
   its 4096 window) against its plain PyTorch version on
   the card, at its path's shapes, with its time, the plain version's
   time and its bound (CUDA events, median of 20 timed runs after
   warm-up); the motion_sad, blockdct and qtransfer forms also with their
   device time a launch (a CUDA graph of 20 launches) and the wrapper's
   host time a call, the diamond forms timed twice in turns.  First four
   sweeps, checked and not timed: small bf16 flash_attention forms across
   the kernel's tile edges (lengths 1 to 257, windows 127 to 129 and 4095
   to 4097 over up to 8200 positions, Sq != Sk, GQA 1/4/8/16, B=3, D=64
   and 128); the four motion_sad forms across
   shapes (16x16 to 480x848, nbx 1 to 53) and radii (0 to 16, and 47 and
   67) on integer, float, constant and 4-px periodic frames, plus a T=3
   batched call and a radius past the kernel's, which must raise; blockdct
   in its raster and block forms over 1, 2 and 30 frames from 8x8 to
   352x640 (odd tile counts a row) at both quality tables; and qtransfer
   in every mode with and without a residual, widths 16 to 336 (not
   multiples of 64), |mv| up to 120;
4. main path: ``roundtrip_chunk`` on 720x1280 sources, 30-frame chunks,
   ladder rung 2 (LR 352x640), full-width TinyDetector from the port's
   ``init``: 2 streams x 3 consecutive chunks.  Launch counters show the
   path went through every kernel;
5. roi: the same chunks through the ROI-gated round trip with the
   diamond bf16 search (80-px regions, the top 36 of 144), in turns with
   the main path's, with its launch counts; then one more chunk of each
   path under torch.profiler, each in a process of its own (device busy
   share, device time by kernel, host time by operator), and the
   admit-all gate against the ungated path;
6. parity: 64x96 chunks through the kernels on the card, every codec
   variant with and without the gate, held against the port's plain
   CPU path;
6b. batched: nine 720p streams of the paper's mix, three chunks, through
   roundtrip_batched and, in turns, nine roundtrip_chunk calls; the mixed
   ladder (rungs 0-4), the padded form with the ROI gate, and the budget
   search; each with its launches a chunk (those of one stream, whatever
   the number of streams), frames/s and peak memory, its lanes held
   against the single-stream runs; one batched chunk profiled in a
   process of its own;
6b'. sharded: the same nine streams, one chunk, split over meshes of 1,
   3, 4 and (2, 2) shards (the card itself, then logical meshes that name
   it several times; a mesh over the cards where there are several):
   shard_roundtrip at rung 2, at the mixed rungs and with the budget
   search, shard_encode, shard_streams on its output and (3 shards) the
   padded canvas with the ROI gate, each bit for bit the batched form and
   launching each kernel n_shards times as often; the rung-2 chunk timed
   against roundtrip_batched in turns; EdgeRuntime in mesh mode on four
   logical shards against logical shards without a mesh, then after a
   failed group, ``remesh`` and a rebuilt runtime.  Before the paths,
   every kernel form is called from a worker thread and held bit for bit
   against the main thread's call (the launch runs under the tensors'
   device);
6c. control: the bi-level control plane (a SAC bandwidth controller, nine
   A2C agents) through ``BiLevelTrainer.create`` / ``run_chunk`` /
   ``run_chunk_loop`` / ``flush`` on the port's biswift_edge configuration
   of nine 720p streams: the detector backend, 8 chunks of the stacked
   path against 8 of the per-stream loop (both updates engaged), held
   against each other; 3 chunks with the ROI gate and the budget search;
   140 chunks of the analytic backend at the paper's hyper-parameters,
   the control step's times acting alone, with the A2C update and with
   both; the steps and one detector chunk profiled in a process of their
   own (device ops, busy share, device-to-host bytes);
6d. serving: the serving plane at the paper's load.
   ``repro_torch.launch.serve.main`` serves nine 720p streams, three
   30-frame chunks, under the SAC controller after its 150-step
   quick-train: the rounds, the split by call (render, encode_hybrid,
   submit_chunk, flush and the detector, poll, NMS and F1), the launches
   of every stream-chunk, peak memory, F1 and latency.  ``run_soak`` at
   nine 720p streams, 12 chunks: loss-burst chunk-sequential and
   batch-submit, equal in every host-decided field; shard-chaos on two
   logical shards, a shard evicted and recovered, one detector dispatch a
   flush group.  One batch-submit round with the ROI gate and the anchor
   search, with its launches; the legacy decode of a 720p packet against
   the fused one; 64x96 packets through the runtime on the card against
   the CPU; one round profiled in a process of its own (busy share,
   device ops, host operators, device-to-host copies and bytes);
6e. train: the TinyDetector trained through ``train/loop.run`` on the
   serving streams for about a minute, checkpointed in the reference's
   layout, restored bit for bit and served by ``serve.main
   --detector-ckpt`` (F1 beside the quick-train run's); ``mm_f32``'s
   backward against autograd through the widened f32 product;
   llama3.2-1B at full width: ``attention_impl="pallas"`` must raise under
   autograd, grad_accum 2 against 1 on one 2x4096 batch, 6 loop steps
   (step time, tokens/s, share of peak, peak memory); a supervised restart
   of a 2-layer cut in a child process with deterministic algorithms, bit
   for bit an unbroken run; every kernel wrapper raising under autograd
   on CUDA;
7. lm: llama3.2-1B at full width and depth (random weights from a seed)
   serves two 4096-token requests: prefill through ``flash_attention``
   (16 launches a prefill, nothing else), 32 greedy decode steps over the
   KV cache (no kernel); every layer's attention held against the plain
   path on the kernel path's inputs, the prefill's logits and caches
   against the plain path's and prefill + one decode step against the
   forward over 4097 tokens held over the first 2 layers (the random-init
   model is chaotic deeper down) and printed for all 16; one prefill and
   one decode step profiled in a process of their own; then
   chatglm3-6B's widths (2 of 28 layers, q/k/v biases on) prefill 1024
   tokens through the D=128 kernel, held against the plain path;
7b. moe: qwen2-moe-a2.7b at full width and depth (14.0 B parameters, 60
   experts top-4 and a shared expert, random weights drawn on the card)
   serves two 4096-token requests: prefill through ``flash_attention``
   (24 launches, the sorted expert dispatch in every layer), 32 greedy
   decode steps (no kernel, the gathered experts); every layer's attention
   held against the plain path, prefill + one decode step against the
   forward over 4097 tokens (2 layers, no capacity drops), layer 0's MoE
   block on the card against the CPU on 512 tokens, and the
   expert-parallel ``moe_block`` on logical (batch x tensor) meshes of
   the card (and over the cards where there are several) against the
   local branch; one prefill and one decode step profiled in a process of
   their own; then mixtral-8x22b at full width, 2 of its 56 layers: two
   8192-token requests through the kernel's window form (window 4096, 2
   launches), 32 decode steps past the window on the 4096-slot ring, the
   same holds against ``swa_attention`` and the forward;
7c. zoo: ResNet-50, ResNet-152, ConvNeXt-B, ViT-B/16, DiT-B/2 and
   DiT-XL/2 at full published width and depth in bf16 (random weights
   from seeds, the reference's init rule), through ``launch.steps``'
   ``materialize``, ``make_infer_fn`` and ``make_train_fn``: the vision
   models serve batches of 1 and 128 at 224 px (median of 10 forwards,
   images/s, peak memory), the DiTs one DDIM step at gen_fast (16 x 1024
   tokens) and gen_1024 (4 x 4096 tokens) and ``sample_with_cache`` over
   gen_fast's four steps refreshing every other step against every step
   (walls, forwards 2 against 4); each trains 3 steps after a warm-up at
   cls_224 or train_256 (step time, images/s, peak memory, finite losses,
   ResNet's running stats moved).  Holds: each model's bf16 output at a
   batch of 1 against its own parameters in f32 on the card (DiT's zero
   leaves redrawn, or the output would be 0), and ResNet-50, ConvNeXt-B,
   ViT-B/16 and DiT-XL/2 at full width, cut in depth, in f32 on the card
   against the port's CPU path.  No kernel of the port is on these paths
   (the reference's zoo reaches no Pallas kernel: its attention is
   ``chunked_attention``, its convolutions XLA's): every call checks that
   none launched.  ResNet-50 at a batch of 128 and one DiT-XL/2 step at
   gen_fast profiled in a process of their own;
7d. dryrun: every cell of ``all_cells()`` through
   ``repro_torch.launch.dryrun.run_cell`` on the single production mesh
   of 256 meta devices (per-device argument bytes against the card's 80
   GiB, FLOPs a step, the layout's and the walk's seconds); then the
   llama3.2-1B train step at [train]'s cut, ResNet-50 serve_b128 and
   DiT-XL/2 gen_fast materialised on the card and held to their layout
   on a 1x1 meta mesh: the arguments' storage the layout's bytes exactly
   (the allocator's growth within its rounding), the FLOPs counted over
   the step on the card the meta count exactly, and the step's median
   wall with its share of 989 TFLOP/s (and, for llama, [train]'s
   6 N tokens share beside it);
8. one JSON line listing the kernels; 9. the JSON result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and bf16
# on the tensor cores (dense) from the port's launch.mesh, f32 outside the
# tensor cores here.  TF32 is off in the port.
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_BF16 as BF16_TC_OPS_PER_S  # noqa: E402
F32_OPS_PER_S = 67e12
F32, BF16 = 4, 2

H_HD, W_HD, T = 720, 1280, 30          # one second of 720p at 30 fps
LEVEL = 2                              # ladder rung 2: LR 352x640
RADIUS = 8
# Eq. 3 thresholds of the main path: on these streams they give all three
# pipelines (the sparse stream) and anchors at every other frame (the
# dense one)
TR1, TR2 = 0.06, 0.015
# the ROI path's gate: 9x16 regions of 80 px, patches of 96 px (halo 8 >=
# the detector's receptive field 7), the top quarter of the regions
ROI = dict(region_px=80, halo=8, capacity=36, threshold=0.0)
ROI_CODEC = dict(search="diamond", dtype="bfloat16")
SOURCE = "src/repro_torch/kernels/csrc/"


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, inner: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back to
    back calls, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = out.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build(names=None) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build(names or build.SOURCES)
    dt = time.perf_counter() - t0
    print(f"[build] {len(reports)} kernel libraries built in {dt:.2f} s "
          f"into {build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line \
                    or "warning" in line.lower():
                print(f"[build] {name}: {line.strip()}")


def _sad_f64(cur, ref, by, bx, dy, dx):
    """One block's SAD at offset (dy, dx) in f64 on the host, against the
    edge-padded reference."""
    import numpy as np
    H, W = ref.shape
    ys = np.clip(np.arange(by * 16, by * 16 + 16) + dy, 0, H - 1)
    xs = np.clip(np.arange(bx * 16, bx * 16 + 16) + dx, 0, W - 1)
    c = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].astype(np.float64)
    return float(np.abs(c - ref[np.ix_(ys, xs)].astype(np.float64)).sum())


# the motion search's sweep, checked and not timed: small shapes at every
# radius below, the ladder's LR shapes (nbx 20, 26, 53) at R=8, and the
# widest radii the kernel takes at one small shape
MOTION_SMALL = ((16, 16), (16, 48), (48, 16), (32, 80))
MOTION_RADII = (0, 1, 2, 4, 7, 8, 9, 16)
MOTION_LARGE = ((176, 320), (240, 416), (480, 848))
MOTION_WIDE = ((32, 80, 47), (32, 80, 67))


def _motion_forms():
    import torch
    return (("exhaustive", None, 96), ("exhaustive", torch.bfloat16, 96),
            ("diamond", None, 131), ("diamond", torch.bfloat16, 131))


def _motion_frames(g, h, w, edge_cases: bool = True):
    """A frame and its shifted, noisier successor, as (cur, ref): float
    and 8-bit integer (exact in bf16); with ``edge_cases``, also a
    constant pair and a pair whose columns repeat every 4 px (dense exact
    ties)."""
    import torch
    dev = torch.device("cuda")
    base = torch.rand((h + 32, w + 32), generator=g, device=dev) * 255
    ref = base[16:16 + h, 16:16 + w].contiguous()
    cur = (base[13:13 + h, 18:18 + w]
           + torch.randn((h, w), generator=g, device=dev) * 3).contiguous()
    frames = {"integer": (cur.round().clamp(0, 255), ref.round()),
              "float": (cur, ref)}
    if edge_cases:
        cols = torch.randint(0, 256, (h + 3, 4), generator=g,
                             device=dev).float()
        periodic = cols.repeat(1, w // 4)
        frames["constant"] = (torch.full((h, w), 77.0, device=dev),) * 2
        frames["periodic"] = (periodic[3:].contiguous(),
                              periodic[:h].contiguous())
    return frames


def _hold_motion(where, mv, sad, mv_p, sad_p, cur, ref, dtype, exact):
    """The kernel's (mv, sad) against the plain version's: exact, or on
    float frames a differing MV must have the plain pick's SAD in f64 (to
    1e-5 relative) and equal MVs SADs within 1e-5 relative.  Returns
    (MVs that differ, max |dsad| where the MVs agree)."""
    import torch
    diff = (mv != mv_p).any(-1)
    n_diff = int(diff.sum())
    if exact:
        if n_diff or not torch.equal(sad, sad_p):
            raise AssertionError(
                f"{where}: {n_diff} MVs differ, max |dsad| "
                f"{float((sad - sad_p).abs().max())}")
        return 0, 0.0
    store = dtype or torch.float32
    c, r = (x.to(store).float().cpu().numpy() for x in (cur, ref))
    for by, bx in diff.nonzero().tolist():
        a = _sad_f64(c, r, by, bx, *mv[by, bx].tolist())
        b = _sad_f64(c, r, by, bx, *mv_p[by, bx].tolist())
        if abs(a - b) > 1e-5 * max(abs(a), abs(b)):
            raise AssertionError(
                f"{where}: block ({by},{bx}) picked {mv[by, bx].tolist()} "
                f"(f64 SAD {a}) where the plain version picked "
                f"{mv_p[by, bx].tolist()} ({b})")
    same = ~diff
    rel = ((sad - sad_p).abs()[same] / sad_p.abs()[same].clamp(min=1e-6))
    if rel.numel() and float(rel.max()) > 1e-5:
        raise AssertionError(f"{where}: SAD rel err {float(rel.max())}")
    return n_diff, float((sad - sad_p).abs()[same].max()) if rel.numel() \
        else 0.0


def check_motion_sad_sweep(g) -> None:
    """Every form of the search against its plain version across the
    sweep's shapes and radii, on integer, float, constant and 4-px
    periodic frames: integer-valued frames exact, bf16 equal to f32 on
    them, a constant frame giving (-R, -R) (exhaustive) or (0, 0)
    (diamond) with SAD 0; then one T=3 batched call equal to three single
    calls.  Checked, not timed."""
    import torch
    from repro_torch.kernels.motion_sad.ops import (MAX_RADIUS, launch_name,
                                                    motion_sad,
                                                    motion_sad_diamond_plain,
                                                    motion_sad_plain)
    cases = [(h, w, r) for h, w in MOTION_SMALL for r in MOTION_RADII]
    cases += [(h, w, RADIUS) for h, w in MOTION_LARGE] + list(MOTION_WIDE)
    n_calls, n_float_diff = 0, 0
    for h, w, radius in cases:
        frames = _motion_frames(g, h, w)
        for search, dtype, _ in _motion_forms():
            name = launch_name(search, dtype)
            plain = motion_sad_diamond_plain if search == "diamond" \
                else motion_sad_plain
            for label, (cur, ref) in frames.items():
                where = f"{name} {label} {h}x{w} R={radius}"
                mv, sad = motion_sad(cur, ref, radius, dtype=dtype,
                                     search=search)
                mv_p, sad_p = plain(cur, ref, radius, dtype=dtype)
                n, _ = _hold_motion(where, mv, sad, mv_p, sad_p, cur, ref,
                                    dtype, exact=label != "float")
                n_calls += 1
                n_float_diff += n
                if label == "constant":
                    pick = -radius if search == "exhaustive" else 0
                    if not (bool((mv == pick).all())
                            and bool((sad == 0).all())):
                        raise AssertionError(f"{where}: not ({pick}, {pick})"
                                             " with SAD 0")
                if dtype is not None and label != "float":
                    mv32, sad32 = motion_sad(cur, ref, radius, search=search)
                    if not (torch.equal(mv, mv32) and torch.equal(sad, sad32)):
                        raise AssertionError(f"{where}: bf16 differs from f32")
    # the batch: T=3 frames in one launch, each equal to its own launch
    cur, ref = (torch.stack(x) for x in zip(*(
        _motion_frames(g, 240, 416, edge_cases=False)["float"]
        for _ in range(3))))
    for search, dtype, _ in _motion_forms():
        mv, sad = motion_sad(cur, ref, RADIUS, dtype=dtype, search=search)
        for t in range(3):
            mv1, sad1 = motion_sad(cur[t], ref[t], RADIUS, dtype=dtype,
                                   search=search)
            if not (torch.equal(mv[t], mv1) and torch.equal(sad[t], sad1)):
                raise AssertionError(f"{launch_name(search, dtype)}: frame "
                                     f"{t} of a T=3 call differs from its "
                                     "own call")
    # the kernel's radius limit: past it a CUDA tensor raises (the plain
    # versions on CPU tensors take any radius, as the reference does)
    for search in ("exhaustive", "diamond"):
        try:
            motion_sad(cur[0], ref[0], MAX_RADIUS + 1, search=search)
        except ValueError:
            continue
        raise AssertionError(f"motion_sad {search} took R={MAX_RADIUS + 1} "
                             "on CUDA tensors")
    torch.cuda.synchronize()
    print(f"[kernels] motion_sad on CUDA tensors at R={MAX_RADIUS + 1} > "
          f"MAX_RADIUS: both searches raise ValueError")
    print(f"[kernels] motion_sad sweep: {len(cases)} (shape, R) cases x 4 "
          f"forms x 4 frame kinds = {n_calls} calls against the plain "
          f"version (shapes {', '.join(f'{h}x{w}' for h, w in MOTION_SMALL)}"
          f" at R={'/'.join(map(str, MOTION_RADII))}; "
          f"{', '.join(f'{h}x{w}' for h, w in MOTION_LARGE)} at R={RADIUS}; "
          f"{', '.join(f'{h}x{w} R={r}' for h, w, r in MOTION_WIDE)}): "
          f"integer, constant and periodic frames exact, bf16 == f32 on "
          f"them; float frames {n_float_diff} MVs differ, each an f64 tie; "
          f"T=3 batch == 3 single calls")


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time a call of ``fn``: a CUDA graph of ``n`` back-to-back
    calls, replayed (median of ``reps``, CUDA events), so that the host
    does not pace the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def host_ms(fn, n: int = 10) -> float:
    """The host's time a call of ``fn`` (checks, allocation, the launch),
    without waiting for the card: the median of ``n`` calls after one
    more, so that an allocator's first cudaMalloc does not count."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def check_motion_sad(g) -> list[dict]:
    """Each form of the search against its plain version at the main
    path's LR shape: MVs and SADs exact on integer frames; on float frames
    a differing MV must have the plain pick's SAD in f64; each diamond
    form's SAD never below its exhaustive form's, bit for bit.  Timed by
    CUDA events over back-to-back wrapper calls, by a CUDA graph of the
    launches (device time a launch) and by the host (wrapper time a
    call); the diamond forms twice, in turns."""
    import torch
    from repro_torch.codec.motion import diamond_num_evals
    from repro_torch.kernels.motion_sad.ops import (launch_name, motion_sad,
                                                    motion_sad_diamond_plain,
                                                    motion_sad_plain)
    h, w = 352, 640
    cases = _motion_frames(g, h, w, edge_cases=False)
    nb = (h // 16) * (w // 16)
    out, integer_f32, float_sad = [], {}, {}
    for search, dtype, line in _motion_forms():
        name = launch_name(search, dtype)
        plain = motion_sad_diamond_plain if search == "diamond" \
            else motion_sad_plain
        max_err = 0.0
        for label, (cur, ref) in cases.items():
            mv, sad = motion_sad(cur, ref, RADIUS, dtype=dtype, search=search)
            mv_p, sad_p = plain(cur, ref, RADIUS, dtype=dtype)
            torch.cuda.synchronize()
            n_diff, err = _hold_motion(f"{name} {label}", mv, sad, mv_p,
                                       sad_p, cur, ref, dtype,
                                       exact=label == "integer")
            if label == "integer":
                # bf16 holds 8-bit integers exactly: it must equal f32
                if dtype is None:
                    integer_f32[search] = (mv, sad)
                elif not (torch.equal(mv, integer_f32[search][0])
                          and torch.equal(sad, integer_f32[search][1])):
                    raise AssertionError(f"{name} differs from its f32 form "
                                         "on 8-bit integer frames")
            else:
                float_sad[search, dtype] = sad
            max_err = max(max_err, err)
            print(f"[kernels] {name} {label:7s} {h}x{w} R={RADIUS}: "
                  f"{n_diff} MVs differ, max |dsad| (same MV) {err:.3g}")
        cur, ref = (x.to(dtype or torch.float32) for x in cases["float"])
        plain_ms = cuda_ms(lambda: plain(cur, ref, RADIUS, dtype=dtype),
                           reps=5, inner=1, warmup=1)
        evals = (2 * RADIUS + 1) ** 2 if search == "exhaustive" \
            else diamond_num_evals(RADIUS)
        item = BF16 if dtype is not None else F32
        b, by = bound_ms(2 * h * w * item + nb * 3 * F32,
                         nb * evals * 256 * 2)
        out.append(dict(
            name=name, mode=f"{search} {'bf16' if dtype else 'f32'}",
            route="cuda", source=SOURCE + "motion_sad.cu",
            replaces=f"src/repro/kernels/motion_sad/kernel.py:{line}",
            max_abs_err=max_err, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=None, shape=f"{h}x{w} R={RADIUS}",
            inputs=(cur, ref, search, dtype)))
    for dtype in (None, torch.bfloat16):
        d, e = float_sad["diamond", dtype], float_sad["exhaustive", dtype]
        if not bool((d >= e).all()):
            raise AssertionError(f"diamond {dtype} SAD below the exhaustive "
                                 f"one at {int((d < e).sum())} blocks")
    print(f"[kernels] motion_sad {h}x{w} R={RADIUS} float frames: each "
          "diamond form's SAD >= its exhaustive form's at every block, bit "
          "for bit")
    # the timings: the exhaustive forms once, the diamond forms twice, in
    # turns
    for k in out[:2] + out[2:] + out[2:]:
        cur, ref, search, dtype = k["inputs"]

        def call():
            return motion_sad(cur, ref, RADIUS, dtype=dtype, search=search)
        times = (cuda_ms(call), graph_ms(call), host_ms(call))
        for key, v in zip(("ms", "device_ms", "host_ms"), times):
            k.setdefault(f"{key}_turns", []).append(v)
            k[key] = k[f"{key}_turns"][0]
    for k in out:
        del k["inputs"]
    return out


def _timed(fn) -> dict:
    """A kernel form's times: CUDA events over back-to-back wrapper calls
    (``ms``), its device time a launch from a CUDA graph (``device_ms``),
    and the wrapper's host time a call (``host_ms``)."""
    return dict(ms=cuda_ms(fn), device_ms=graph_ms(fn), host_ms=host_ms(fn))


def _hold_blockdct(where, q, rec, qp, recp) -> tuple[float, float, int]:
    """The kernel's (q (F, nb, 8, 8), rec (F, H, W)) against the plain
    version's: max|dq| <= 1, and rec within 1e-3 on every tile whose q
    agrees.  Returns (max |drec| there, sum |dq|, coefficients)."""
    from repro_torch.kernels.blockdct.ops import blockify
    dq = (q - qp).abs()
    agree = (dq == 0).flatten(2).all(-1)
    drec = (blockify(rec) - blockify(recp)).abs()[agree]
    err = float(drec.max()) if drec.numel() else 0.0
    if float(dq.max()) > 1 or err > 1e-3:
        raise AssertionError(f"{where}: max|dq| {float(dq.max())}, max|drec| "
                             f"where q agrees {err}")
    return err, float(dq.sum()), dq.numel()


def _blockdct_forms(frames, D, qt, where) -> tuple:
    """The raster forward on ``frames`` (F, H, W), held against the plain
    version, against the block form on the same tiles (bit for bit), and
    its rec against the inverse of its own q (bit for bit).  Returns
    (q, rec, max |drec|, sum |dq|, coefficients)."""
    import torch
    from repro_torch.kernels.blockdct import ops
    F, H, W = frames.shape
    q, rec = ops.forward_quant_raster(frames, D, qt)
    qp, recp = ops.forward_quant_raster_plain(frames, D, qt)
    qb, recb = ops.forward_quant(
        ops.blockify(frames).reshape(-1, 8, 8).contiguous(), D, qt)
    torch.cuda.synchronize()
    err, dq_sum, n = _hold_blockdct(where, q, rec, qp, recp)
    if not (torch.equal(qb, q.reshape(-1, 8, 8)) and torch.equal(
            recb, ops.blockify(rec).reshape(-1, 8, 8))):
        raise AssertionError(f"{where}: the raster and block forms differ")
    if not torch.equal(ops.inverse_raster(q, D, qt, H, W), rec):
        raise AssertionError(f"{where}: inverse(q) differs from the "
                             "forward's rec")
    return q, rec, err, dq_sum, n


# the transform's sweep, checked and not timed: frame counts, and shapes
# down to one tile and with an odd number of tiles a row
BLOCKDCT_FRAMES = (1, 2, 30)
BLOCKDCT_SHAPES = ((8, 8), (8, 24), (24, 40), (64, 96), (352, 640))
QUALITIES = (50.0, 70.0)               # the LR codec's and the anchors'


def check_blockdct_sweep(g) -> None:
    """Both entries in both forms across BLOCKDCT_FRAMES x BLOCKDCT_SHAPES
    x QUALITIES: the forward within its contract of the plain version,
    the raster and block forms bit for bit, inverse(q) equal to the
    forward's rec, the inverse within 1e-3 of its plain version and its
    two forms bit for bit.  Checked, not timed."""
    import torch
    from repro_torch.codec.blockdct import dct_matrix, quant_table
    from repro_torch.kernels.blockdct import ops
    dev = torch.device("cuda")
    D = dct_matrix(8, dev)
    cases, dq_sum, n_coef, worst = 0, 0.0, 0, 0.0
    for F in BLOCKDCT_FRAMES:
        for H, W in BLOCKDCT_SHAPES:
            frames = torch.rand((F, H, W), generator=g, device=dev) * 255 - 128
            for quality in QUALITIES:
                qt = quant_table(quality, dev)
                where = f"blockdct F={F} {H}x{W} q{quality:.0f}"
                q, _, err, s, n = _blockdct_forms(frames, D, qt, where)
                dq_sum, n_coef = dq_sum + s, n_coef + n
                rec = ops.inverse_raster(q, D, qt, H, W)
                recp = ops.inverse_raster_plain(q, D, qt, H, W)
                recb = ops.inverse(q.reshape(-1, 8, 8), D, qt)
                torch.cuda.synchronize()
                inv_err = float((rec - recp).abs().max())
                if inv_err > 1e-3 or not torch.equal(
                        recb, ops.blockify(rec).reshape(-1, 8, 8)):
                    raise AssertionError(f"{where}: inverse max|drec| "
                                         f"{inv_err}, or its forms differ")
                worst = max(worst, err, inv_err)
                cases += 1
    if dq_sum / n_coef >= 0.01:
        raise AssertionError(f"blockdct sweep: mean|dq| {dq_sum / n_coef}")
    print(f"[kernels] blockdct sweep: {cases} cases (F "
          f"{'/'.join(map(str, BLOCKDCT_FRAMES))} x "
          f"{', '.join(f'{h}x{w}' for h, w in BLOCKDCT_SHAPES)} x q"
          f"{'/'.join(f'{q:.0f}' for q in QUALITIES)}): forward max|dq| "
          f"<= 1, mean|dq| {dq_sum / n_coef:.2e} over {n_coef} "
          f"coefficients, max|drec| {worst:.3g} (forward where q agrees, "
          "and inverse); raster == block form and inverse(q) == the "
          "forward's rec, bit for bit")


def check_blockdct(g) -> list[dict]:
    """The forward at the anchor encode's shape (30 frames of 720x1280,
    quality 70) and the LR codec's (one 352x640 frame, quality 50), the
    inverse at the decoder's (30 frames of 352x640): each held against
    its plain version (and both qualities at the anchor shape), its block
    form and, for the forward, the inverse of its own q; then timed."""
    import torch
    from repro_torch.codec.blockdct import dct_matrix, quant_table
    from repro_torch.kernels.blockdct import ops
    dev = torch.device("cuda")
    D = dct_matrix(8, dev)
    common = dict(route="cuda", source=SOURCE + "blockdct.cu",
                  replaces="src/repro/kernels/blockdct/kernel.py:41",
                  library_ms=None)
    out = []
    for label, shape, qualities in (
            ("anchor encode", (T, H_HD, W_HD), QUALITIES),
            ("LR transform", (1, 352, 640), QUALITIES[:1])):
        frames = torch.rand(shape, generator=g, device=dev) * 255 - 128
        n_px = math.prod(shape)
        fwd_err = 0.0
        for quality in qualities:
            qt = quant_table(quality, dev)
            where = f"blockdct forward {'x'.join(map(str, shape))} " \
                    f"q{quality:.0f}"
            _, _, err, dq_sum, n = _blockdct_forms(frames, D, qt, where)
            print(f"[kernels] {where} ({label}): mean|dq| {dq_sum / n:.2e}, "
                  f"max|drec| where q agrees {err:.3g}; raster == block "
                  "form, inverse(q) == rec, bit for bit")
            if dq_sum / n >= 0.01:
                raise AssertionError(f"{where}: mean|dq| {dq_sum / n}")
            fwd_err = max(fwd_err, err)
        b, by = bound_ms(3 * n_px * F32, n_px * 4 * 8 * 2)
        out.append(dict(
            name="blockdct_forward", mode=f"forward_quant, {label}",
            max_abs_err=fwd_err,
            plain_ms=cuda_ms(lambda: ops.forward_quant_raster_plain(
                frames, D, qt), reps=5, inner=1, warmup=1),
            bound_ms=b, bound_by=by, shape="x".join(map(str, shape)),
            **_timed(lambda: ops.forward_quant_raster(frames, D, qt)),
            **common))

    # the decoder's inverse over the LR residuals of one chunk
    H, W = 352, 640
    qt = quant_table(QUALITIES[0], dev)
    frames = torch.rand((T, H, W), generator=g, device=dev) * 255 - 128
    q, _ = ops.forward_quant_raster_plain(frames, D, qt)
    rec = ops.inverse_raster(q, D, qt, H, W)
    recp = ops.inverse_raster_plain(q, D, qt, H, W)
    recb = ops.inverse(q.reshape(-1, 8, 8), D, qt)
    torch.cuda.synchronize()
    inv_err = float((rec - recp).abs().max())
    print(f"[kernels] blockdct inverse {T}x{H}x{W}: max|drec| {inv_err:.3g}")
    if inv_err > 1e-3:
        raise AssertionError("blockdct inverse disagrees with its plain "
                             "version")
    if not torch.equal(recb, ops.blockify(rec).reshape(-1, 8, 8)):
        raise AssertionError("blockdct inverse: the raster and block forms "
                             "differ")
    n_px = T * H * W
    b, by = bound_ms(2 * n_px * F32, n_px * 2 * 8 * 2)
    out.append(dict(
        name="blockdct_inverse", mode="inverse, decoder", max_abs_err=inv_err,
        plain_ms=cuda_ms(lambda: ops.inverse_raster_plain(q, D, qt, H, W),
                         reps=5, inner=1, warmup=1),
        bound_ms=b, bound_by=by, shape=f"{T}x{H}x{W}",
        **_timed(lambda: ops.inverse_raster(q, D, qt, H, W)), **common))
    return out


def check_blockdct_tables(g) -> dict:
    """The forward with one table a frame at the anchor shape (30 frames of
    720x1280, two tables in turns, as a mixed-ladder step or the budget
    search gives them): bit for bit the launches of each table on its own
    frames, its inverse the forward's rec; then its device time a launch
    (CUDA graph) beside the one-table form's, in turns."""
    import torch
    from repro_torch.codec.blockdct import dct_matrix, quant_table
    from repro_torch.kernels.blockdct import ops
    dev = torch.device("cuda")
    D = dct_matrix(8, dev)
    frames = torch.rand((T, H_HD, W_HD), generator=g, device=dev) * 255 - 128
    qualities = [QUALITIES[f % 2] for f in range(T)]
    tables = quant_table(qualities, dev)
    q, rec = ops.forward_quant_raster(frames, D, tables)
    for i, quality in enumerate(QUALITIES):
        q1, rec1 = ops.forward_quant_raster(frames[i::2].contiguous(), D,
                                            quant_table(quality, dev))
        if not (torch.equal(q[i::2], q1) and torch.equal(rec[i::2], rec1)):
            raise AssertionError(f"blockdct per-frame tables: the q"
                                 f"{quality:.0f} frames differ from a "
                                 "launch at that table alone")
    if not torch.equal(ops.inverse_raster(q, D, tables, H_HD, W_HD), rec):
        raise AssertionError("blockdct per-frame tables: inverse(q) differs "
                             "from the forward's rec")
    qp, recp = ops.forward_quant_raster_plain(frames, D, tables)
    torch.cuda.synchronize()
    err, dq_sum, n = _hold_blockdct("blockdct per-frame tables", q, rec, qp,
                                    recp)
    one = quant_table(QUALITIES[1], dev)
    same = one.expand(T, 8, 8).contiguous()
    if not all(torch.equal(a, b) for a, b in zip(
            ops.forward_quant_raster(frames, D, same),
            ops.forward_quant_raster(frames, D, one))):
        raise AssertionError("blockdct: one table repeated a frame differs "
                             "from the (8, 8) form")
    graphs = {}
    for label, qt in (("tables", tables), ("one", one), ("tables", tables),
                      ("one", one)):
        graphs.setdefault(label, []).append(graph_ms(
            lambda: ops.forward_quant_raster(frames, D, qt)))
    print(f"[kernels] blockdct forward {T}x{H_HD}x{W_HD}, a table a frame "
          f"(q{QUALITIES[0]:.0f}/q{QUALITIES[1]:.0f} in turns): == each "
          "table's own launch and inverse(q) == rec, bit for bit; one table "
          f"repeated == the (8, 8) form; mean|dq| {dq_sum / n:.2e} against "
          f"the plain version; device "
          f"{', '.join(f'{v * 1e3:.2f}' for v in graphs['tables'])} us a "
          f"launch (CUDA graph) against the (8, 8) form's "
          f"{', '.join(f'{v * 1e3:.2f}' for v in graphs['one'])} us, in "
          "turns")
    n_px = T * H_HD * W_HD
    b, by = bound_ms(3 * n_px * F32 + tables.numel() * F32, n_px * 4 * 8 * 2)
    return dict(
        name="blockdct_forward", mode="forward_quant, a table a frame",
        route="cuda", source=SOURCE + "blockdct.cu",
        replaces="src/repro/kernels/blockdct/kernel.py:41", library_ms=None,
        max_abs_err=err, bound_ms=b, bound_by=by,
        plain_ms=cuda_ms(lambda: ops.forward_quant_raster_plain(
            frames, D, tables), reps=5, inner=1, warmup=1),
        shape=f"{T}x{H_HD}x{W_HD} per-frame tables",
        device_ms_one_table=graphs["one"][0],
        form_path="batched_ladder",
        **_timed(lambda: ops.forward_quant_raster(frames, D, tables)))


# seq_sum's timed grids (lanes, rows, cols): the LR codec's 8x8-block bits
# of 9 streams x 30 frames at 352x640, and the anchors' of 30 HD frames
# (one stream) and of 270 (nine streams: the batched path's largest grid)
SEQ_SUM_SHAPES = ((270, 44, 80), (30, 90, 160), (270, 90, 160))
# checked, not timed: the (S, 1, T) video and anchor bits of nine streams
# (several lanes a block), one stream's LR bits, rows past a block's tile
# (row tiles, with many lanes and with few), rows wider than a staging
# buffer (column tiles), and odd shapes (4-byte copies)
SEQ_SUM_CHECKED = ((9, 1, 30), (30, 44, 80), (132, 200, 160),
                   (2, 2000, 160), (2, 1, 40000), (3, 1, 200), (5, 200, 1),
                   (4, 7, 13))
# the chain of dependent adds a lane: one row of 2^18 columns, which
# measures the time of one add in the kernel's scan
SEQ_SUM_CHAIN = (1, 1, 1 << 18)
# a timed grid's copies, read in turns, span this many bytes: over twice
# the H100's 50 MB L2, so that each call reads its grid from HBM, as the
# bytes bound assumes
SEQ_SUM_COLD_BYTES = 128 << 20
# the latency of one f32 add that depends on the one before, in SM
# cycles: 4 on Volta (Jia et al., "Dissecting the NVIDIA Volta GPU
# Architecture via Microbenchmarking", arXiv:1804.06826), taken as
# Hopper's; check_seq_sum measures it at SEQ_SUM_CHAIN beside the bound
FADD_LATENCY_CYCLES = 4


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _seq_sum_numpy(x):
    """The reference's order on the host: each row left to right in f32,
    then the row totals, one numpy f32 add a column (every lane and row
    at once), then one a row."""
    import numpy as np
    rows = np.zeros(x.shape[:2], np.float32)
    for c in range(x.shape[2]):
        rows = (rows + x[:, :, c]).astype(np.float32)
    total = np.zeros(x.shape[0], np.float32)
    for r in range(x.shape[1]):
        total = (total + rows[:, r]).astype(np.float32)
    return total


def _seq_sum_grid(g, shape, misaligned: bool = False):
    """Normal values scaled over 7 decades, where the order shows; with
    ``misaligned``, stored 4 bytes past a 16-byte boundary (the kernel's
    4-byte copies)."""
    import torch
    dev = torch.device("cuda")
    scale = 10.0 ** (torch.rand(shape, generator=g, device=dev) * 7 - 3)
    x = torch.randn(shape, generator=g, device=dev) * scale
    if misaligned:
        buf = torch.empty(x.numel() + 1, device=dev)
        buf[1:] = x.flatten()
        x = buf[1:].view(shape)
    return x


def _rotating(fn, xs):
    """``fn`` on each of ``xs`` in turn, one a call."""
    turns = itertools.cycle(xs)
    return lambda: fn(next(turns))


def check_seq_sum(g) -> list[dict]:
    """The order-stable sum on the card: bit for bit its plain version
    (one add a column) and a numpy f32 loop on the host, on grids of
    widely scaled values (where the order shows) and on a grid with zero
    padding (which must add nothing), at SEQ_SUM_SHAPES (timed; the first
    also stored misaligned) and SEQ_SUM_CHECKED; then the time of one add
    of a lane's chain at SEQ_SUM_CHAIN.  The kernel and ``torch.sum`` over
    the grid (the same sum, in another order; ``library_ms`` and
    ``library_device_ms``) are timed by events and from a CUDA graph on
    copies of the grid read in turns, which the L2 cannot hold
    (SEQ_SUM_COLD_BYTES); ``*_warm_ms`` from a graph on one copy, read
    from the L2.  The bound is the larger of the bytes at the HBM rate and
    a lane's chain of C + R dependent adds at FADD_LATENCY_CYCLES and the
    card's highest clock."""
    import numpy as np
    import torch
    from repro_torch.kernels.seq_sum import ops
    seq_sum, seq_sum_plain = ops.seq_sum, ops.seq_sum_plain
    clock = max_sm_clock_hz()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    cases = [(s, False) for s in SEQ_SUM_SHAPES + SEQ_SUM_CHECKED]
    cases.insert(1, (SEQ_SUM_SHAPES[0], True))
    for shape, misaligned in cases:
        L, R, C = shape
        x = _seq_sum_grid(g, shape, misaligned)
        got = seq_sum(x)
        plain = seq_sum_plain(x)
        host = _seq_sum_numpy(x.cpu().numpy())
        padded = seq_sum(torch.nn.functional.pad(x, (0, 5, 0, 3)))
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and np.array_equal(got.cpu().numpy(),
                                                           host)
                and torch.equal(padded, got)):
            raise AssertionError(f"seq_sum {shape}: the kernel, its plain "
                                 "version and the host loop differ")
        differs = int((got != x.sum(dim=(1, 2))).sum())
        p = ops.plan(L, R, C, n_sms)
        print(f"[kernels] seq_sum {L}x{R}x{C}"
              f"{' (misaligned)' if misaligned else ''}: == plain version == "
              f"numpy f32 loop, bit for bit; zero padding adds nothing; "
              f"torch.sum differs in {differs} of {L} lanes; plan: "
              f"{p.grid(L)} blocks of {p.threads} threads, "
              f"{p.lanes_per_cta} lanes a block, tiles "
              f"{p.tile_rows}x{p.tile_cols} in {p.buffers} buffer(s), "
              f"{p.smem_bytes(R)} B shared")
        if shape not in SEQ_SUM_SHAPES or misaligned:
            continue
        t_bytes = (L * R * C + L) * F32 / HBM_BYTES_PER_S * 1e3
        t_chain = (C + R) * FADD_LATENCY_CYCLES / clock * 1e3
        b, by = max((t_bytes, "bytes"), (t_chain, "operations"))

        n_copies = -(-SEQ_SUM_COLD_BYTES // (x.numel() * F32))
        xs = [x] + [x.clone() for _ in range(n_copies - 1)]
        n_calls = max(20, n_copies)

        def library(y):
            return y.sum(dim=(1, 2))
        kernel_cold = _rotating(seq_sum, xs)
        library_cold = _rotating(library, xs)
        out.append(dict(
            name="seq_sum", mode="lanes x rows x cols", route="cuda",
            source=SOURCE + "seq_sum.cu",
            replaces="src/repro/codec/blockdct.py:95 (seq_sum, lax.scan; "
                     "no Pallas kernel)",
            max_abs_err=0.0, bound_ms=b, bound_by=by,
            bound_bytes_ms=t_bytes, bound_chain_ms=t_chain,
            plain_ms=cuda_ms(lambda: seq_sum_plain(x), reps=5, inner=1,
                             warmup=1),
            library_ms=cuda_ms(library_cold),
            library_device_ms=graph_ms(library_cold, n=n_calls),
            library_device_warm_ms=graph_ms(lambda: library(x)),
            shape=f"{L}x{R}x{C}", ms=cuda_ms(kernel_cold),
            device_ms=graph_ms(kernel_cold, n=n_calls),
            device_warm_ms=graph_ms(lambda: seq_sum(x)),
            host_ms=host_ms(lambda: seq_sum(x))))
        k = out[-1]
        print(f"[kernels] seq_sum {L}x{R}x{C}: bound {b * 1e3:.2f} us "
              f"({by}: bytes {t_bytes * 1e3:.2f} us, chain of {C + R} adds "
              f"{t_chain * 1e3:.2f} us at {clock / 1e6:.0f} MHz); device us "
              f"a call (CUDA graph of {n_calls}, {n_copies} copies in turns; "
              f"one copy, from the L2): kernel {k['device_ms'] * 1e3:.2f} "
              f"(warm {k['device_warm_ms'] * 1e3:.2f}), torch.sum "
              f"{k['library_device_ms'] * 1e3:.2f} (warm "
              f"{k['library_device_warm_ms'] * 1e3:.2f}); events kernel "
              f"{k['ms'] * 1e3:.2f}, torch.sum {k['library_ms'] * 1e3:.2f}; "
              f"host {k['host_ms'] * 1e3:.2f}")
        del xs, kernel_cold, library_cold
    # one lane of one row: the kernel's time is its chain of adds
    x = _seq_sum_grid(g, SEQ_SUM_CHAIN)
    got = seq_sum(x)
    ref = np.cumsum(x.cpu().numpy()[0, 0], dtype=np.float32)[-1]
    torch.cuda.synchronize()
    if float(got[0]) != float(ref):
        raise AssertionError(f"seq_sum {SEQ_SUM_CHAIN}: {float(got[0])} "
                             f"against the host's sequential {float(ref)}")
    t = graph_ms(lambda: seq_sum(x), n=5, reps=5)
    n_adds = SEQ_SUM_CHAIN[2] + SEQ_SUM_CHAIN[1]
    print(f"[kernels] seq_sum chain {'x'.join(map(str, SEQ_SUM_CHAIN))}: == "
          f"numpy's sequential f32 cumsum; {t * 1e3:.1f} us a launch (CUDA "
          f"graph) = {t * 1e6 / n_adds:.3f} ns an add = "
          f"{t * 1e-3 / n_adds * clock:.2f} cycles at {clock / 1e6:.0f} MHz "
          f"(the bound takes {FADD_LATENCY_CYCLES})")
    return out


def _qtransfer_inputs(g, B, H, W, max_mv, step=1, dtype=None):
    """anchor in [0, 255), a residual of std 8 (both in ``dtype``) and
    motion vectors in [-max_mv, max_mv], multiples of ``step``."""
    import torch
    dev = torch.device("cuda")
    anchor = torch.rand((B, H, W), generator=g, device=dev) * 255
    resid = torch.randn((B, H, W), generator=g, device=dev) * 8
    mv = torch.randint(-(max_mv // step), max_mv // step + 1,
                       (B, H // 16, W // 16, 2), generator=g, device=dev,
                       dtype=torch.int32) * step
    if dtype is not None:
        anchor, resid = anchor.to(dtype), resid.to(dtype)
    return anchor, mv, resid


def _hold_qtransfer(where, anchor, mv, resid, **kw) -> None:
    """The kernel equal to its plain version, bit for bit."""
    import torch
    from repro_torch.kernels.qtransfer.ops import qtransfer, qtransfer_plain
    out = qtransfer(anchor, mv, resid, **kw)
    ref = qtransfer_plain(anchor, mv, resid, **kw)
    torch.cuda.synchronize()
    if out.dtype != ref.dtype or not torch.equal(out, ref):
        err = float((out.float() - ref.float()).abs().max())
        raise AssertionError(f"{where}: not exact (max err {err})")


# the gather's sweep, checked and not timed: widths of one macroblock and
# not multiples of 64, MVs far past the frame, in small steps and in
# 16-byte-aligned steps (the kernel's one-load runs)
QTRANSFER_SHAPES = ((1, 16, 16), (2, 48, 16), (3, 32, 48), (2, 64, 80),
                    (1, 96, 208), (4, 176, 336))
QTRANSFER_MVS = ((120, 1), (3, 1), (16, 4), (24, 8))


def check_qtransfer_sweep(g) -> None:
    """Every form (pixel f32, block f32, block bf16; block radii 0, 16 and
    200 in turn) with and without a residual across QTRANSFER_SHAPES x
    QTRANSFER_MVS, each exact against its plain version."""
    import torch
    bf = torch.bfloat16
    forms = (("pixel", None), ("block", None), ("block", bf))
    calls = 0
    for B, H, W in QTRANSFER_SHAPES:
        for max_mv, step in QTRANSFER_MVS:
            for edge, dtype in forms:
                anchor, mv, resid = _qtransfer_inputs(g, B, H, W, max_mv,
                                                      step, dtype)
                radius = (0, 16, 200)[calls // 2 % 3]
                for r in (None, resid):
                    _hold_qtransfer(
                        f"qtransfer {edge} {dtype} {B}x{H}x{W} |mv|<="
                        f"{max_mv} step {step} resid={r is not None}",
                        anchor, mv, r, edge=edge, radius=radius, dtype=dtype)
                    calls += 1
    print(f"[kernels] qtransfer sweep: {calls} calls exact (pixel f32, block "
          f"f32 and bf16 at radii 0/16/200, with and without a residual; "
          f"{', '.join('x'.join(map(str, s)) for s in QTRANSFER_SHAPES)}; "
          f"|mv| <= {'/'.join(str(m) for m, _ in QTRANSFER_MVS)} in steps "
          f"of {'/'.join(str(s) for _, s in QTRANSFER_MVS)})")


def check_qtransfer(g) -> list[dict]:
    """The quality transfer's form (30 frames of 720x1280, pixel edge, a
    residual, |mv| <= 24), both edges with and without the residual at
    that shape, the motion compensation's (one 352x640 frame, pixel edge,
    no residual, |mv| <= 8) and the bf16 block form at the HD shape: each
    exact against its plain version, then timed."""
    import torch
    from repro_torch.kernels.qtransfer.ops import qtransfer, qtransfer_plain
    common = dict(route="cuda", source=SOURCE + "qtransfer.cu",
                  replaces="src/repro/kernels/qtransfer/kernel.py:50",
                  library_ms=None, max_abs_err=0.0)
    shape = (T, H_HD, W_HD)
    anchor, mv, resid = _qtransfer_inputs(g, *shape, 24)
    for edge in ("pixel", "block"):
        for r in (None, resid):
            _hold_qtransfer(f"qtransfer edge={edge} resid={r is not None}",
                            anchor, mv, r, edge=edge)
    print(f"[kernels] qtransfer edge=pixel/block, gather and gather+resid+"
          f"clip, {'x'.join(map(str, shape))} |mv|<=24: exact")
    n = math.prod(shape)
    b, by = bound_ms(3 * n * F32 + mv.numel() * 4, 2 * n)
    out = [dict(name="qtransfer", mode="pixel, quality transfer",
                plain_ms=cuda_ms(lambda: qtransfer_plain(
                    anchor, mv, resid, edge="pixel")),
                bound_ms=b, bound_by=by,
                shape="x".join(map(str, shape)) + " pixel+resid",
                **_timed(lambda: qtransfer(anchor, mv, resid, edge="pixel")),
                **common)]

    lr = (1, 352, 640)
    a_lr, mv_lr, _ = _qtransfer_inputs(g, *lr, RADIUS)
    _hold_qtransfer("qtransfer LR bare gather", a_lr, mv_lr, None,
                    edge="pixel")
    print(f"[kernels] qtransfer edge=pixel gather {'x'.join(map(str, lr))} "
          f"|mv|<={RADIUS}: exact")
    n_lr = math.prod(lr)
    b, by = bound_ms(2 * n_lr * F32 + mv_lr.numel() * 4, 0)
    out.append(dict(name="qtransfer", mode="pixel, motion compensation",
                    plain_ms=cuda_ms(lambda: qtransfer_plain(
                        a_lr, mv_lr, edge="pixel")),
                    bound_ms=b, bound_by=by,
                    shape="x".join(map(str, lr)) + " pixel bare",
                    **_timed(lambda: qtransfer(a_lr, mv_lr, edge="pixel")),
                    **common))

    # bf16 storage, block mode: gather and add in f32, one rounding
    bf = torch.bfloat16
    a16, r16 = anchor.to(bf), resid.to(bf)
    _hold_qtransfer("qtransfer_bf16 block", a16, mv, r16, edge="block",
                    dtype=bf)
    print(f"[kernels] qtransfer_bf16 edge=block gather+resid+clip "
          f"{'x'.join(map(str, shape))} |mv|<=24: exact")
    b16, by16 = bound_ms(3 * n * BF16 + mv.numel() * 4, 2 * n)
    out.append(dict(name="qtransfer_bf16", mode="block, bf16 storage",
                    plain_ms=cuda_ms(lambda: qtransfer_plain(
                        a16, mv, r16, edge="block", dtype=bf)),
                    bound_ms=b16, bound_by=by16,
                    shape="x".join(map(str, shape)) + " block+resid",
                    **_timed(lambda: qtransfer(a16, mv, r16, edge="block",
                                               dtype=bf)),
                    **common))
    return out


def check_roi_gather(g) -> dict:
    """The ROI path's gather: T=30 halo-padded 720x1280 planes, K=36 lanes
    of 96x96 patches; exact.  ``library_ms`` times the one PyTorch call
    the plain version is built on: advanced indexing of an ``unfold``
    view of every (P, P) window."""
    import torch
    from repro_torch.kernels.roi_gather.ops import roi_gather, \
        roi_gather_plain
    dev = torch.device("cuda")
    rp, halo, K = ROI["region_px"], ROI["halo"], ROI["capacity"]
    P = rp + 2 * halo
    planes = torch.rand((T, H_HD + 2 * halo, W_HD + 2 * halo), generator=g,
                        device=dev) - 0.5
    # K distinct regions a frame, as roi_select gives them
    nx = W_HD // rp
    idx = torch.rand((T, (H_HD // rp) * nx), generator=g,
                     device=dev).argsort(dim=1)[:, :K]
    ry, rx = (idx // nx).int(), (idx % nx).int()
    out = roi_gather(planes, ry, rx, region_px=rp, halo=halo)
    ref = roi_gather_plain(planes, ry, rx, region_px=rp, halo=halo)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("roi_gather is not exact")
    # the least the gather reads: the union of its lanes' source windows
    # (neighbouring patches share their halo strips)
    ar = torch.arange(P, device=dev)
    read = torch.zeros_like(planes, dtype=torch.bool)
    read[torch.arange(T, device=dev)[:, None, None, None],
         (ry.long() * rp)[..., None, None] + ar[:, None],
         (rx.long() * rp)[..., None, None] + ar] = True
    read_bytes = int(read.sum()) * F32
    print(f"[kernels] roi_gather T={T} K={K} P={P} on {T}x{H_HD + 2 * halo}x"
          f"{W_HD + 2 * halo} planes: exact; reads {read_bytes / 1e6:.2f} MB "
          f"(distinct source bytes), writes {out.numel() * F32 / 1e6:.2f} MB")
    ms = cuda_ms(lambda: roi_gather(planes, ry, rx, region_px=rp, halo=halo))
    plain = cuda_ms(lambda: roi_gather_plain(planes, ry, rx, region_px=rp,
                                             halo=halo))
    windows = planes.unfold(1, P, 1).unfold(2, P, 1)
    t = torch.arange(T, device=dev)[:, None]
    ys, xs = ry.long() * rp, rx.long() * rp
    library = cuda_ms(lambda: windows[t, ys, xs])
    b, by = bound_ms(read_bytes + out.numel() * F32 + 2 * ry.numel() * 4, 0)
    return dict(name="roi_gather", mode="f32", route="cuda",
                source=SOURCE + "roi_gather.cu",
                replaces="src/repro/kernels/roi_gather/kernel.py:40",
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=library,
                shape=f"T={T} K={K} P={P}")


# the flash_attention forms [kernels] holds against the plain version:
# (label, B, H, Hk, Sq, Sk, D, causal, window, dtype); the first is the
# llama3.2-1B prefill's shape (one request), the second chatglm3-6b's
# heads, the last two the [moe] prefills' (two requests each)
FLASH_FORMS = [
    ("llama3.2-1b heads", 1, 32, 8, 4096, 4096, 64, True, None, "bf16"),
    ("chatglm3-6b heads", 1, 32, 2, 2048, 2048, 128, True, None, "bf16"),
    ("window 1024", 1, 48, 8, 4096, 4096, 128, True, 1024, "bf16"),
    ("cross Sq=64 Sk=192", 2, 32, 8, 64, 192, 64, True, None, "bf16"),
    ("non-causal", 1, 32, 8, 2048, 2048, 64, False, None, "bf16"),
    ("ragged S=1000", 1, 32, 8, 1000, 1000, 64, True, None, "bf16"),
    ("f32 inputs", 1, 32, 8, 1024, 1024, 64, True, None, "f32"),
    ("qwen2-moe heads", 2, 16, 16, 4096, 4096, 128, True, None, "bf16"),
    ("mixtral heads, window 4096", 2, 48, 8, 8192, 8192, 128, True, 4096,
     "bf16"),
]
# the path that runs each form at its very shape
FLASH_FORM_PATHS = {"llama3.2-1b heads": "lm", "chatglm3-6b heads": "chatglm3",
                    "qwen2-moe heads": "moe",
                    "mixtral heads, window 4096": "mixtral"}
# the plain version's f32 scores of a call above this many bytes go one
# request at a time (mixtral's: 2 x 25.8 GB)
FLASH_PLAIN_BYTES = 16 << 30
# small forms that cross the bf16 design's tiles (128 q rows a block, 64
# a consumer warpgroup, 128 keys a K/V tile), checked against the plain
# version and not timed: (label, B, H, Hk, Sq, Sk, D, causal, window)
FLASH_SWEEP = [
    *((f"S={n} D={d}", 1, 8, 2, n, n, d, True, None)
      for n in (1, 127, 128, 129, 255, 257) for d in (64, 128)),
    *((f"non-causal S={n} D={d}", 1, 8, 2, n, n, d, False, None)
      for n in (127, 129, 257) for d in (64, 128)),
    *((f"window {w} D={d}", 1, 8, 2, 515, 515, d, True, w)
      for w in (127, 128, 129) for d in (64, 128)),
    ("non-causal window 128", 1, 8, 2, 515, 515, 64, False, 128),
    *((f"causal Sq={sq} Sk={sk} D={d}", 1, 8, 2, sq, sk, d, True, None)
      for sq, sk in ((129, 300), (300, 129), (1, 257)) for d in (64, 128)),
    *((f"GQA {16 // hk} D={d}", 1, 16, hk, 300, 300, d, True, None)
      for hk in (16, 4, 1) for d in (64, 128)),
    *((f"B=3 D={d}", 3, 8, 2, 257, 257, d, True, 200) for d in (64, 128)),
    # mixtral's window past the tile edges of a long sequence
    *((f"window {w} S={n} D=128", 1, 8, 1, n, n, 128, True, w)
      for w, n in ((4096, 4225), (4095, 8200), (4097, 8200))),
]
# the reference's absolute tolerances (tests/test_kernels.py:36), plus
# 2^-8 of |value|: half a bf16 ulp, since above |o| = 4 one ulp of the
# bf16 output (0.03125) exceeds 0.03 and a kernel that rounds p to bf16
# lands on the other side of a rounding step now and then
FLASH_TOL = {"bf16": 0.03, "f32": 0.02}
FLASH_RTOL = 2.0 ** -8
# the LM path: llama3.2-1B at full width and depth, two requests of 4096
# tokens, then greedy decode
LM_BATCH, LM_SEQ, LM_DECODE = 2, 4096, 32
# logits held as max|d| / max|logit|; caches and each layer's attention
# output as max|d| / max|value|
LM_REL_TOL = 0.05
# layers of full width over which the model is held end to end (see
# phase_lm)
LM_HELD_LAYERS = 2


def _flash_inputs(g, B, H, Hk, Sq, Sk, D, dtype):
    import torch
    dev = torch.device("cuda")
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D))]


def _flash_excess(o, ref, dt) -> tuple[float, float]:
    """(max|o - ref|, its largest excess over FLASH_TOL + 2^-8 |ref|)."""
    d = (o.float() - ref.float()).abs()
    excess = d - FLASH_TOL[dt] - FLASH_RTOL * ref.float().abs()
    return float(d.max()), float(excess.max())


def check_flash_sweep(g) -> None:
    """The FLASH_SWEEP forms in bf16 against the plain version; raises
    naming every form that disagrees (or is not finite)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    failed, worst = [], 0.0
    for label, B, H, Hk, Sq, Sk, D, causal, window in FLASH_SWEEP:
        q, k, v = _flash_inputs(g, B, H, Hk, Sq, Sk, D, torch.bfloat16)
        kw = dict(causal=causal, window=window)
        o = flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        err, excess = _flash_excess(o, ref, "bf16")
        worst = max(worst, err)
        if not excess <= 0:
            bad = ((o.float() - ref.float()).abs() > FLASH_TOL["bf16"]
                   + FLASH_RTOL * ref.float().abs())
            rows = bad.any(-1).any(-1).nonzero()[:, 1]
            failed.append(f"{label} (B={B} H={H} Hk={Hk} Sq={Sq} Sk={Sk} "
                          f"window={window}): max|d| {err:.3g}, rows "
                          f"{rows.min().item()}..{rows.max().item()}, "
                          f"{int(bad.sum())} values")
    torch.cuda.synchronize()
    print(f"[kernels] flash_attention sweep: {len(FLASH_SWEEP)} bf16 forms "
          f"across the tile edges, max|d| {worst:.3g} vs plain (tolerance "
          f"{FLASH_TOL['bf16']} + 2^-8 |value|), {len(failed)} disagree")
    if failed:
        raise AssertionError("flash_attention disagrees with its plain "
                             "version:\n" + "\n".join(failed))


def check_flash_attention(g, labels=None) -> list[dict]:
    """Each form (or those named in ``labels``) against its plain version
    (``attention_ref`` in f32) on the card, with its time, the plain
    version's, and the library's: one ``scaled_dot_product_attention``
    call on (B, H, S, D) views (a boolean mask for the window form).  The
    bound counts the unmasked pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    dev = torch.device("cuda")
    out = []
    for label, B, H, Hk, Sq, Sk, D, causal, window, dt in FLASH_FORMS:
        if labels is not None and label not in labels:
            continue
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v = _flash_inputs(g, B, H, Hk, Sq, Sk, D, dtype)
        kw = dict(causal=causal, window=window)
        plain = _plain_by_request if 4 * B * H * Sq * Sk > FLASH_PLAIN_BYTES \
            else flash_attention_plain
        o = flash_attention(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if o.dtype != dtype or o.shape != q.shape:
            raise AssertionError(f"flash_attention {label}: {o.dtype} "
                                 f"{tuple(o.shape)}")
        err, excess = _flash_excess(o, ref, dt)
        print(f"[kernels] flash_attention {label} B={B} H={H} Hk={Hk} "
              f"Sq={Sq} Sk={Sk} D={D} {dt}: max|d| {err:.3g} vs plain "
              f"(tolerance {FLASH_TOL[dt]} + 2^-8 |value|)")
        if not excess <= 0:
            raise AssertionError(f"flash_attention {label} disagrees with "
                                 f"its plain version: {err}")
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
        # the wrapper's host time a call: checks, tensor maps, the launch
        host = host_ms(lambda: flash_attention(q, k, v, **kw))
        del ref
        plain_ms = cuda_ms(lambda: plain(q, k, v, **kw),
                           reps=5, inner=1, warmup=1)
        q_pos = torch.arange(Sq, device=dev)[:, None]
        k_pos = torch.arange(Sk, device=dev)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        pairs = int(mask.sum())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        masking = dict(is_causal=causal) if window is None \
            else dict(attn_mask=mask)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **masking))
        item = q.element_size()
        # the products run on the bf16 tensor cores for f32 inputs too
        b, by = bound_ms((2 * B * Sq * H + 2 * B * Sk * Hk) * D * item,
                         4 * B * H * D * pairs, BF16_TC_OPS_PER_S)
        out.append(dict(
            name="flash_attention", mode=label, route="cuda",
            source=SOURCE + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:75",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=library, host_ms=host,
            shape=f"B={B} H={H} Hk={Hk} Sq={Sq} Sk={Sk} D={D} {dt}"
                  + (f" window={window}" if window else "")
                  + ("" if causal else " non-causal"),
            # the path that runs this very form, if one does
            form_path=FLASH_FORM_PATHS.get(label)))
    return out


def _plain_by_request(q, k, v, **kw):
    """The plain version one request at a time: the same values, and half
    the f32 scores of the whole call at a time."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    return torch.cat([flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], **kw)
                      for i in range(q.shape[0])])


def _rel_err(a, b) -> float:
    """max|a - b| over max|b|, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _hold_logits(tag: str, got, ref, gate: bool = True,
                 phase: str = "lm", tol: float = LM_REL_TOL) -> None:
    """Logits within ``tol`` of the reference's scale, and the same
    greedy pick in every row, or picks whose reference logits differ by
    less than the measured max|d| (a near tie).  ``gate=False`` prints
    the comparison only; ``phase`` names the line's phase."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[{phase}] {tag}: logits are not finite")
    rel = _rel_err(got, ref)
    d = float((got.float() - ref.float()).abs().max())
    pick, pick_ref = got.argmax(-1), ref.argmax(-1)
    gap = (ref.gather(-1, pick_ref[..., None])
           - ref.gather(-1, pick[..., None])).abs().max()
    same = float((pick == pick_ref).float().mean())
    print(f"[{phase}] {tag}: max|dlogit| {d:.4g} = {rel:.4g} of max|logit| "
          f"{float(ref.abs().max()):.4g} "
          f"({f'tolerance {tol}' if gate else 'not held'}); argmax "
          f"agrees in {same:.3f} of rows, largest gap at a differing pick "
          f"{float(gap):.3g}")
    if not gate:
        return
    if not rel <= tol:
        raise AssertionError(f"[{phase}] {tag}: logits disagree ({rel})")
    if float(gap) > d:
        raise AssertionError(f"[{phase}] {tag}: greedy picks differ beyond a "
                             f"near tie ({float(gap)} > {d})")


def _expect_launches(where: str, expected: dict) -> None:
    """The launch counts since the last reset must be ``expected``
    exactly: each kernel named, and no other."""
    from repro_torch.kernels import build
    got = dict(build.LAUNCHES)
    for name in set(expected) | set(got):
        if got.get(name, 0) != expected.get(name, 0):
            raise AssertionError(f"{where}: {name} launched "
                                 f"{got.get(name, 0)} times, expected "
                                 f"{expected.get(name, 0)}")


def phase_lm() -> dict:
    """llama3.2-1B, full width and depth, ``attention_impl="pallas"``,
    random weights from a seed: ``materialize`` and ``make_infer_fn``
    prefill two requests of 4096 seeded tokens (one warm-up, then three
    timed with CUDA events), the cache goes into ``cache_len(cfg, 4096 +
    32)`` slots, and 32 greedy ``decode_step``s follow.  Each prefill must
    launch exactly 16 ``flash_attention`` and nothing else, the decode no
    kernel.  Then every layer's attention is held against the plain path
    (``attention_impl="xla"``) on the kernel path's inputs; the prefill's
    logits and caches against the plain path's, and prefill + one decode
    step against ``forward`` over 4097 tokens, over the first
    LM_HELD_LAYERS layers, and printed for all 16.  Returns the launches
    of one prefill."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeCase, get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_infer_fn, materialize
    from repro_torch.models import transformer_lm as M
    from repro_torch.models.params import param_bytes
    base = get_arch("llama3_2_1b")
    arch = dataclasses.replace(base, cfg=dataclasses.replace(
        base.cfg, attention_impl="pallas"))
    cfg = arch.cfg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    case = ShapeCase("prefill_4k", "prefill", batch=LM_BATCH, seq_len=LM_SEQ)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, batch = materialize(g, arch, case)
    torch.cuda.synchronize()
    print(f"[lm] {cfg.name}: {cfg.param_count():,} parameters, "
          f"{param_bytes(M.param_specs(cfg)) / 2**30:.2f} GiB in bf16, "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    prefill = make_infer_fn(arch, case)
    per_prefill = {"flash_attention": cfg.n_layers}
    times = []
    for i in range(4):
        build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, kv = prefill(params, batch)
        end.record()
        end.synchronize()
        launched = dict(build.LAUNCHES)
        _expect_launches("[lm] prefill", per_prefill)
        if i:
            times.append(start.elapsed_time(end))
    if logits.shape != (LM_BATCH, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[lm] prefill logits {tuple(logits.shape)}")
    prefill_ms = statistics.median(times)
    print(f"[lm] prefill {LM_BATCH}x{LM_SEQ} tokens: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms, median "
          f"{prefill_ms:.2f} ms ({LM_BATCH * LM_SEQ / prefill_ms * 1e3:.0f} "
          f"tokens/s); launches per prefill {launched}")

    seq_len = LM_SEQ + LM_DECODE
    cache = M.cache_from_prefill(cfg, kv, seq_len)
    decode = make_infer_fn(arch, ShapeCase("decode", "decode",
                                           batch=LM_BATCH, seq_len=seq_len))
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    steps = []
    build.reset_launches()
    for i in range(LM_DECODE):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache,
                                    {"tokens": tok, "pos": LM_SEQ + i})
        end.record()
        tok = step_logits[:, -1].argmax(-1, keepdim=True).int()
        steps.append((start, end))
    torch.cuda.synchronize()
    _expect_launches("[lm] decode", {})
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError("[lm] decode logits are not finite")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in steps)
    print(f"[lm] decode: {LM_DECODE} greedy steps of {LM_BATCH} requests "
          f"over a {seq_len}-slot cache: median {step_ms:.3f} ms a step "
          f"({LM_BATCH / step_ms * 1e3:.1f} decoded tokens/s); no kernel "
          f"launch; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The holds.  With the reference's random weights the full-depth model
    # is chaotic: its fan_in rule scales wq/wk by the head count, so q and
    # k have std ~8 and ~16 and the scores ~100, attention is close to an
    # argmax, and two valid roundings of one layer part by O(1) a few
    # layers on.  So every layer's attention is held on the kernel path's
    # own inputs, the model end to end over its first LM_HELD_LAYERS
    # layers, and the full-depth comparisons are printed.
    xla = dataclasses.replace(cfg, attention_impl="xla")
    rels, tf_logits = _attention_per_layer(params, cfg, batch["tokens"])
    if not torch.equal(tf_logits, logits):
        raise AssertionError("[lm] the per-layer loop is not the model's")
    print(f"[lm] each layer's attention output, kernel vs plain on the "
          f"kernel path's inputs (max|d| / max|value|, tolerance "
          f"{LM_REL_TOL}): {', '.join(f'{r:.3g}' for r in rels)}")
    if not max(rels) <= LM_REL_TOL:
        raise AssertionError(f"[lm] a layer's attention disagrees: {rels}")
    logits_x, kv_x = M.prefill_step(params, xla, batch["tokens"])
    for name, a, b in (("k", kv[0], kv_x[0]), ("v", kv[1], kv_x[1])):
        if not torch.equal(a[0], b[0]):
            raise AssertionError(f"[lm] layer 0 {name} differs: it comes "
                                 "before any attention")
    _hold_logits(f"prefill pallas vs xla, all {cfg.n_layers} layers",
                 logits, logits_x, gate=False)
    by_layer = [_rel_err(a, b) for a, b in zip(kv[0], kv_x[0])]
    print(f"[lm] cache k pallas vs xla by layer (not held): "
          f"{', '.join(f'{r:.3g}' for r in by_layer)}")
    del logits_x, kv_x

    extra = torch.randint(0, cfg.vocab, (LM_BATCH, 1), generator=g,
                          device=dev, dtype=torch.int32)
    tokens1 = torch.cat([batch["tokens"], extra], 1)
    held = dataclasses.replace(cfg, n_layers=LM_HELD_LAYERS)
    params_held = dict(params, blocks={k: v[:LM_HELD_LAYERS]
                                       for k, v in params["blocks"].items()})
    for c, p, gate in ((held, params_held, True), (cfg, params, False)):
        n = c.n_layers
        if gate:
            lp, kvp = M.prefill_step(p, c, batch["tokens"])
            lx, kvx = M.prefill_step(
                p, dataclasses.replace(c, attention_impl="xla"),
                batch["tokens"])
            _hold_logits(f"prefill pallas vs xla, {n} of {cfg.n_layers} "
                         "layers", lp, lx)
            rel = max(_rel_err(kvp[0], kvx[0]), _rel_err(kvp[1], kvx[1]))
            print(f"[lm] prefill cache pallas vs xla, {n} layers: max|d| "
                  f"{rel:.4g} of max|value| (tolerance {LM_REL_TOL})")
            if not rel <= LM_REL_TOL:
                raise AssertionError(f"[lm] caches disagree ({rel})")
        else:
            kvp = kv
        # prefill + one decode step == forward over S + 1 tokens (the
        # last q and k tiles ragged)
        full = M.forward(p, c, tokens1)[0]
        full_last = full[:, -1:].clone()
        del full
        step, _ = M.decode_step(p, c,
                                M.cache_from_prefill(c, kvp, LM_SEQ + 1),
                                extra, LM_SEQ)
        _hold_logits(f"prefill {LM_SEQ} + decode vs forward {LM_SEQ + 1}, "
                     f"{n} layers", step, full_last, gate=gate)
    return launched


def _attention_per_layer(params, cfg, tokens):
    """The prefill's layer loop (``transformer_lm._trunk``) on the kernel
    path, each layer's attention also taken by the plain path on the same
    inputs: (max|d| / max|value| per layer, last-position logits)."""
    import dataclasses
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as M
    xla = dataclasses.replace(cfg, attention_impl="xla")
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = M._embed(params, cfg, tokens)
    rels = []
    for i in range(cfg.n_layers):
        p = M._layer(params, i)
        xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        h, _ = M._attn(cfg, p, xn, positions)
        rels.append(_rel_err(h, M._attn(xla, p, xn, positions)[0]))
        x = x + h
        x = x + M._ffn(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))[0]
    return rels, M._logits(params, cfg, x[:, -1:])


def phase_chatglm3() -> dict:
    """chatglm3-6b at full width, 2 of its 28 layers, q/k/v biases on
    (seeded, nonzero): prefill of one 1024-token request with the kernel
    (D=128, GQA 16, half RoPE) against the plain attention path.  Returns
    the launches of one prefill."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import transformer_lm as M
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_arch("chatglm3_6b").cfg, n_layers=2,
                              qkv_bias=True, attention_impl="pallas")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    params = init_params(g, M.param_specs(cfg), dev)
    for name in ("bq", "bk", "bv"):
        params["blocks"][name].normal_(0.0, 0.02, generator=g)
    tokens = torch.randint(0, cfg.vocab, (1, 1024), generator=g, device=dev,
                           dtype=torch.int32)
    build.reset_launches()
    logits, kv = M.prefill_step(params, cfg, tokens)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    _expect_launches("[lm] chatglm3 prefill",
                     {"flash_attention": cfg.n_layers})
    logits_x, kv_x = M.prefill_step(
        params, dataclasses.replace(cfg, attention_impl="xla"), tokens)
    _hold_logits("chatglm3-6b (2 of 28 layers) prefill 1x1024 pallas vs "
                 "xla", logits, logits_x)
    rel = max(_rel_err(kv[0], kv_x[0]), _rel_err(kv[1], kv_x[1]))
    print(f"[lm] chatglm3-6b cache pallas vs xla: max|d| {rel:.4g} of "
          f"max|value|; launches {launches}")
    if not rel <= LM_REL_TOL:
        raise AssertionError(f"[lm] chatglm3 cache disagrees ({rel})")
    return launches


# [moe]: qwen2-moe-a2.7b at full width and depth, and mixtral-8x22b at
# full width and MIXTRAL_LAYERS of its 56 layers (all 56 are 281 GB in
# bf16; two are 10.4 GB), each serving MOE_BATCH requests: prefill, then
# greedy decode (mixtral's past its 4096-token window, on the ring cache)
MOE_BATCH, MOE_DECODE = 2, 32
QWEN_SEQ, MIXTRAL_SEQ, MIXTRAL_LAYERS = 4096, 8192, 2
# one layer's MoE block on the card against the CPU on MOE_HELD_TOKENS
# tokens: the top-k expert sets equal wherever the k-th routing
# probability exceeds the next by more than MOE_MARGIN (the two devices'
# f32 router products part by ~1e-7), and the outputs of the tokens routed
# alike within MOE_TOL of max|out| (4 bf16 ulps: the expert GEMMs' f32
# sums run in another order, so a bf16 output moves by an ulp now and then)
MOE_HELD_TOKENS = 512
MOE_MARGIN = 1e-4
MOE_TOL = 4 * 2.0 ** -8
# the expert-parallel branch against the local one, max|d| / max|out|: the
# tensor shards' partial sums are rounded to bf16 before they are added,
# and a partial can be several times the sum where the d_ff slices cancel
# (measured 0.0144 at qwen2-moe's layer 0 on 2 x 4096 tokens; a lost
# shard's partial reads 0.87 and more, tests/test_torch_moe.py)
MOE_SHARD_TOL = 2.0 ** -5
# prefill + decode against the forward, 2 layers, max|d| / max|logit|:
# the CPU tests' bf16-model tolerance (tests/test_torch_moe.py), twice the
# dense [lm]'s. In the random-init models the residual stream after layer
# 0 is its attention output (max|x| 221 in qwen2-moe, 700 in mixtral,
# against an FFN output of ~1), and layer 1's attention turns the
# one-ulp difference between decode_attention and the kernel there into
# 0.06 (qwen2-moe) and 0.11 (mixtral) of its output: measured 0.0489 and
# 0.0783, against 0.0023 and 0.0044 through one layer (LM_REL_TOL) and
# 0.0015 for mixtral with f32 activations (_moe_decode_gaps prints each)
MOE_REL_TOL = 0.1
# decode_attention over the prefill's cache (mixtral's ring) on the
# forward's own q, k, v, max|d| / max against the exact f32 attention:
# 2.5 bf16 ulps (measured 0.0022-0.0034; the kernel's 0.0022-0.0024)
MOE_ATTN_TOL = 0.01
MOE_MESHES = ((1, 2), (2, 2), (1, 4))      # (data, model): batch x tensor


def _moe_arch(arch_id: str, n_layers=None):
    """The arch with ``attention_impl="pallas"`` (and ``n_layers`` cut)."""
    import dataclasses
    from repro_torch.configs import get_arch
    base = get_arch(arch_id)
    cfg = dataclasses.replace(base.cfg, attention_impl="pallas")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return dataclasses.replace(base, cfg=cfg)


def _no_drops(cfg):
    """``cfg`` whose sorted dispatch drops nothing (C = T): a token's
    result then does not depend on the tokens around it, so prefill +
    decode must give the forward's last position."""
    import dataclasses
    moe = dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def _serve_moe(tag: str, arch, seq: int) -> dict:
    """``materialize`` (random weights from seed 0, drawn on the card) and
    ``make_infer_fn``: MOE_BATCH requests of ``seq`` tokens prefilled (a
    warm-up, then three timed with CUDA events), each prefill launching
    one ``flash_attention`` a layer and nothing else and taking the sorted
    dispatch in every layer; the cache from the prefill
    (``cache_from_prefill``), then MOE_DECODE greedy decode steps, which
    launch no kernel and take the gathered path in every layer."""
    import torch
    from repro_torch.configs import ShapeCase
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_infer_fn, materialize
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as M
    from repro_torch.models.params import param_bytes
    cfg = arch.cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    case = ShapeCase("prefill", "prefill", batch=MOE_BATCH, seq_len=seq)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, batch = materialize(g, arch, case)
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name}, {cfg.n_layers} layers: "
          f"{cfg.param_count():,} parameters "
          f"({cfg.active_param_count():,} active), "
          f"{param_bytes(M.param_specs(cfg)) / 2**30:.2f} GiB in bf16, drawn "
          f"on the card in {time.perf_counter() - t0:.2f} s")
    prefill = make_infer_fn(arch, case)
    per_prefill = {"flash_attention": cfg.n_layers}
    times = []
    for i in range(4):
        build.reset_launches()
        L.reset_moe_branches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, kv = prefill(params, batch)
        end.record()
        end.synchronize()
        launched = dict(build.LAUNCHES)
        _expect_launches(f"[moe] {tag} prefill", per_prefill)
        if dict(L.MOE_BRANCHES) != {"sorted": cfg.n_layers}:
            raise AssertionError(f"[moe] {tag} prefill branches "
                                 f"{dict(L.MOE_BRANCHES)}")
        if i:
            times.append(start.elapsed_time(end))
    if logits.shape != (MOE_BATCH, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[moe] {tag} prefill logits "
                             f"{tuple(logits.shape)}")
    prefill_ms = statistics.median(times)
    print(f"[moe] {tag} prefill {MOE_BATCH}x{seq} tokens: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms, median "
          f"{prefill_ms:.2f} ms ({MOE_BATCH * seq / prefill_ms * 1e3:.0f} "
          f"tokens/s); launches per prefill {launched}; MoE branches per "
          f"prefill {dict(L.MOE_BRANCHES)}")

    seq_len = seq + MOE_DECODE
    cache = M.cache_from_prefill(cfg, kv, seq_len)
    decode = make_infer_fn(arch, ShapeCase("decode", "decode",
                                           batch=MOE_BATCH, seq_len=seq_len))
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    steps = []
    build.reset_launches()
    L.reset_moe_branches()
    for i in range(MOE_DECODE):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache,
                                    {"tokens": tok, "pos": seq + i})
        end.record()
        tok = step_logits[:, -1].argmax(-1, keepdim=True).int()
        steps.append((start, end))
    torch.cuda.synchronize()
    _expect_launches(f"[moe] {tag} decode", {})
    # one token a request: T·k < E, the gathered path, at both models'
    # widths (2·4 < 60, 2·2 < 8)
    branch = "sorted" if MOE_BATCH * cfg.moe.top_k >= cfg.moe.n_experts \
        else "gathered"
    if dict(L.MOE_BRANCHES) != {branch: cfg.n_layers * MOE_DECODE}:
        raise AssertionError(f"[moe] {tag} decode branches "
                             f"{dict(L.MOE_BRANCHES)}")
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError(f"[moe] {tag} decode logits are not finite")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in steps)
    ring = cache["k"].shape[2]
    print(f"[moe] {tag} decode: {MOE_DECODE} greedy steps of {MOE_BATCH} "
          f"requests, positions {seq}..{seq_len - 1} over a {ring}-slot "
          f"{'ring ' if cfg.window else ''}cache: median {step_ms:.3f} ms a "
          f"step ({MOE_BATCH / step_ms * 1e3:.1f} decoded tokens/s); no "
          f"kernel launch, the {branch} path in all {cfg.n_layers} layers; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(params=params, tokens=batch["tokens"], logits=logits,
                launched=launched, prefill_ms=prefill_ms, step_ms=step_ms)


def _moe_input(params, cfg, tokens):
    """Layer 0's FFN input (its MoE block's x) for ``tokens``."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as M
    import torch
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    p = M._layer(params, 0)
    x = M._embed(params, cfg, tokens)
    h, _ = M._attn(cfg, p, L.rms_norm(x, p["ln1"], cfg.norm_eps), positions)
    return L.rms_norm(x + h, p["ln2"], cfg.norm_eps)


def _hold_moe_layers(tag: str, served: dict, cfg, seq: int) -> None:
    """Every layer's attention, kernel vs plain on the kernel path's inputs
    (``swa_attention`` for mixtral's window); then prefill + one decode
    step against ``forward`` over seq + 1 tokens through the first
    LM_HELD_LAYERS layers, with no capacity drops (:func:`_no_drops`,
    :func:`_moe_decode_gaps`)."""
    import dataclasses
    import torch
    from repro_torch.models import transformer_lm as M
    params, tokens = served["params"], served["tokens"]
    rels, tf_logits = _attention_per_layer(params, cfg, tokens)
    if not torch.equal(tf_logits, served["logits"]):
        raise AssertionError(f"[moe] {tag}: the per-layer loop is not the "
                             "model's")
    plain = "swa_attention" if cfg.window else "chunked_attention"
    print(f"[moe] {tag} each layer's attention output, kernel vs {plain} on "
          f"the kernel path's inputs (max|d| / max|value|, tolerance "
          f"{LM_REL_TOL}): {', '.join(f'{r:.3g}' for r in rels)}")
    if not max(rels) <= LM_REL_TOL:
        raise AssertionError(f"[moe] {tag}: a layer's attention disagrees: "
                             f"{rels}")
    n = min(LM_HELD_LAYERS, cfg.n_layers)
    held = _no_drops(dataclasses.replace(cfg, n_layers=n))
    p = dict(params, blocks={k: v[:n] for k, v in params["blocks"].items()})
    g = torch.Generator(device=tokens.device).manual_seed(5)
    extra = torch.randint(0, cfg.vocab, (tokens.shape[0], 1), generator=g,
                          device=tokens.device, dtype=torch.int32)
    _moe_decode_gaps(tag, p, held, tokens, extra, seq)


def _decode_vs_forward(p, cfg, tokens, extra, seq: int) -> dict:
    """Prefill of ``tokens`` (seq positions), its cache and one decode
    step of ``extra``, and the forward over all seq + 1 tokens: the
    decode logits ("step"), the forward's last position ("last"), each
    path's ``router_topk`` calls ("fwd", "pre", "dec") and the forward's
    and the prefill's k, v ("kv_f", "kv"), the prefill's cache before the
    decode step writes to it ("ring")."""
    import torch
    from repro_torch.models import transformer_lm as M
    with _router_inputs() as fwd:
        full, _, kv_f = M.forward(p, cfg, torch.cat([tokens, extra], 1),
                                  collect_cache=True)
    last = full[:, -1:].clone()
    del full
    with _router_inputs() as pre:
        _, kv = M.prefill_step(p, cfg, tokens)
    cache = M.cache_from_prefill(cfg, kv, seq + 1)
    ring = {k: v.clone() for k, v in cache.items()}
    with _router_inputs() as dec:
        step, _ = M.decode_step(p, cfg, cache, extra, seq)
    return dict(step=step, last=last, fwd=fwd, pre=pre, dec=dec, kv_f=kv_f,
                kv=kv, ring=ring)


def _exact_last(q, k, v, pos: int, window) -> "torch.Tensor":
    """Position ``pos``'s attention (q's last row, (B, 1, H, D)) in f32
    over the keys it sees: causal, within ``window``."""
    B, _, H, D = q.shape
    lo = 0 if window is None else max(0, pos - window + 1)
    G = H // k.shape[2]
    kf = k[:, lo:pos + 1].float().repeat_interleave(G, 2)
    vf = v[:, lo:pos + 1].float().repeat_interleave(G, 2)
    s = (q[:, -1].float()[:, None] * kf).sum(-1) * D ** -0.5   # (B, n, H)
    return (s.softmax(1)[..., None] * vf).sum(1)[:, None]


def _moe_decode_gaps(tag: str, p, held, tokens, extra, seq: int) -> None:
    """Prefill + one decode step against the forward over seq + 1 tokens,
    with no capacity drops.  Held: (a) the prefill's routing and k, v of
    the seq tokens equal to the forward's, exactly; (b) its cache
    (mixtral's 4096-slot ring) holding the forward's k, v at the positions
    its ``slot_pos`` names, bit for bit; (c) each layer's
    ``decode_attention`` over that cache, on the forward's q, k, v of the
    last position, within MOE_ATTN_TOL of the exact f32 attention (the
    kernel's error printed beside it); (d) the logits through the first
    layer within LM_REL_TOL, through both within MOE_REL_TOL.  Printed:
    the last token's experts by the two paths, and, layer by layer, how
    far the decode step's last token is from the forward's after the
    attention and after the FFN (the FFN also on the forward's own
    input), and the same comparison in f32 weights and activations with
    the plain attention."""
    import dataclasses
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models import transformer_lm as M
    n, B, k = held.n_layers, tokens.shape[0], held.moe.top_k
    gaps = []
    for j in range(1, n + 1):
        r = _decode_vs_forward(
            dict(p, blocks={kk: v[:j] for kk, v in p["blocks"].items()}),
            dataclasses.replace(held, n_layers=j), tokens, extra, seq)
        gaps.append(_rel_err(r["step"], r["last"]))
    for i in range(n):
        idx_f = r["fwd"][i][2].reshape(B, seq + 1, k)[:, :seq].sort(-1)[0]
        idx_p = r["pre"][i][2].reshape(B, seq, k).sort(-1)[0]
        moved = int((idx_f != idx_p).any(-1).sum())
        same = all(torch.equal(a[i], b[i][:, :seq])
                   for a, b in zip(r["kv"], r["kv_f"]))
        if moved or not same:
            raise AssertionError(f"[moe] {tag} layer {i}: the prefill routes "
                                 f"{moved} tokens otherwise than the forward"
                                 f", k and v equal: {same}")
    ring, (k_f, v_f) = r["ring"], r["kv_f"]
    Sc = ring["k"].shape[2]
    kept = torch.arange(max(0, seq - Sc), seq, device=tokens.device)
    want = torch.full((Sc,), -1, dtype=torch.int32, device=tokens.device)
    want[kept % Sc] = kept.int()
    if not (torch.equal(ring["slot_pos"], want)
            and torch.equal(ring["k"][:, :, kept % Sc], k_f[:, :, kept])
            and torch.equal(ring["v"][:, :, kept % Sc], v_f[:, :, kept])):
        raise AssertionError(f"[moe] {tag}: the cache from the prefill is not "
                             "the forward's k, v at its slots")
    print(f"[moe] {tag}: the prefill of {seq} tokens against the forward's "
          f"first {seq}: routing and k, v equal in all {n} layers; its "
          f"{Sc}-slot {'ring' if held.window else 'cache'} holds the "
          f"forward's k, v of positions {int(kept[0])}..{seq - 1} bit for "
          f"bit")
    flips, margins = 0, []
    for (xf, w, _), (xd, _, _) in zip(r["fwd"], r["dec"]):
        xf = xf.reshape(B, -1, xf.shape[-1])[:, -1]
        pf = torch.softmax(xf.float() @ w.float(), -1)
        pd = torch.softmax(xd.float() @ w.float(), -1)
        top_f = pf.sort(-1, descending=True)
        flips += int((top_f[1][:, :k].sort(-1)[0]
                      != pd.topk(k)[1].sort(-1)[0]).any(-1).sum())
        margins += (top_f[0][:, k - 1] - top_f[0][:, k]).tolist()
    print(f"[moe] {tag}: the last token's top-{k} experts, decode vs "
          f"forward: {flips} of {len(margins)} (layer, request) decisions "
          f"differ; the forward's smallest margin {min(margins):.3g}")
    positions = torch.arange(seq + 1, dtype=torch.int32, device=tokens.device)
    slot_pos = ring["slot_pos"].clone()
    slot_pos[seq % Sc] = seq
    # the forward's layers over every token (x) beside the decode step's
    # for the last one (xd, over the prefill's cache)
    x = M._embed(p, held, torch.cat([tokens, extra], 1))
    xd = M._embed(p, held, extra)
    attn = []
    for i in range(n):
        pi = M._layer(p, i)
        xn = L.rms_norm(x, pi["ln1"], held.norm_eps)
        q, kk, vv = M._qkv(held, pi, xn, positions)
        exact = _exact_last(q, kk, vv, seq, held.window)
        ck, cv = ring["k"][i].clone(), ring["v"][i].clone()
        ck[:, seq % Sc], cv[:, seq % Sc] = kk[:, -1], vv[:, -1]
        dec = L.decode_attention(q[:, -1:], ck, cv, cache_positions=slot_pos,
                                 pos=seq, window=held.window)
        ker = flash_attention(q, kk, vv, causal=True,
                              window=held.window)[:, -1:]
        attn.append((_rel_err(dec, exact), _rel_err(ker, exact)))
        qd, kd, vd = M._qkv(held, pi, L.rms_norm(xd, pi["ln1"],
                                                 held.norm_eps), positions[-1:])
        ck[:, seq % Sc], cv[:, seq % Sc] = kd[:, 0], vd[:, 0]
        od = L.decode_attention(qd, ck, cv, cache_positions=slot_pos,
                                pos=seq, window=held.window)
        h = M._attn(held, pi, xn, positions)[0]
        hd = L.mm_f32(od.reshape(B, 1, -1),
                      pi["wo"].reshape(-1, x.shape[-1])).to(xd.dtype)
        x, xd = x + h, xd + hd
        after_attn = (_rel_err(hd, h[:, -1:]), _rel_err(xd, x[:, -1:]))
        xm = L.rms_norm(x, pi["ln2"], held.norm_eps)
        f = M._ffn(held, pi, xm)[0]
        fd = M._ffn(held, pi, L.rms_norm(xd, pi["ln2"], held.norm_eps))[0]
        own = M._ffn(held, pi, xm[:, -1:])[0]
        x, xd = x + f, xd + fd
        print(f"[moe] {tag} layer {i}, the last token, decode vs forward "
              f"(max|d| / max of the forward's): attention out "
              f"{after_attn[0]:.3g}, residual after it {after_attn[1]:.3g}; "
              f"FFN out {_rel_err(fd, f[:, -1:]):.3g}, on the forward's own "
              f"input {_rel_err(own, f[:, -1:]):.3g}; residual after it "
              f"{_rel_err(xd, x[:, -1:]):.3g}; max|x| "
              f"{float(x[:, -1].abs().max()):.4g}, max|attention out| "
              f"{float(h[:, -1].abs().max()):.4g}, max|FFN out| "
              f"{float(f[:, -1].abs().max()):.4g}")
    rebuilt = _rel_err(M._logits(p, held, xd), M._logits(p, held, x[:, -1:]))
    print(f"[moe] {tag} each layer's attention of the last position on the "
          f"forward's q, k, v against the exact f32 attention (max|d| / max, "
          f"tolerance {MOE_ATTN_TOL}): decode_attention over the "
          f"{'ring' if held.window else 'cache'} "
          f"{', '.join(f'{a:.3g}' for a, _ in attn)}; the kernel "
          f"{', '.join(f'{b:.3g}' for _, b in attn)}")
    if not max(a for a, _ in attn) <= MOE_ATTN_TOL:
        raise AssertionError(f"[moe] {tag}: decode_attention over the cache "
                             f"disagrees: {attn}")
    step, last = r["step"], r["last"]
    del x, xd, q, kk, vv, ck, cv, r, f, xm
    f32 = dataclasses.replace(held, dtype="float32", attention_impl="xla")
    p32 = {name: ({kk: v.float() for kk, v in t.items()}
                  if isinstance(t, dict) else t.float())
           for name, t in p.items()}
    r32 = _decode_vs_forward(p32, f32, tokens[:1], extra[:1], seq)
    print(f"[moe] {tag}: prefill + decode vs forward in f32 weights and "
          f"activations, the plain attention, request 0, {n} layers: "
          f"{_rel_err(r32['step'], r32['last']):.4g} of max|logit|; the "
          f"layer-by-layer rebuild above {rebuilt:.4g} (bf16)")
    del p32, r32
    print(f"[moe] {tag}: prefill + decode vs forward through 1..{n} layers "
          f"(max|dlogit| / max|logit|, tolerances {LM_REL_TOL} for one, "
          f"{MOE_REL_TOL} for two): {', '.join(f'{x:.4g}' for x in gaps)}")
    if not gaps[0] <= LM_REL_TOL:
        raise AssertionError(f"[moe] {tag}: one layer's prefill + decode vs "
                             f"forward {gaps[0]}")
    _hold_logits(f"{tag}: prefill {seq} + decode vs forward {seq + 1}, "
                 f"{n} layers, no drops"
                 + (f", a {Sc}-slot ring" if held.window else ""),
                 step, last, phase="moe", tol=MOE_REL_TOL)


class _router_inputs:
    """Records (x, w_router, expert indices) of every ``router_topk`` call
    in its block."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self._topk, self.seen = L.router_topk, []

        def spy(x, w, moe):
            out = self._topk(x, w, moe)
            self.seen.append((x, w, out[0]))
            return out

        L.router_topk = spy
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.router_topk = self._topk


def _hold_moe_block_cpu(tag: str, params, cfg, x) -> None:
    """Layer 0's MoE block on the card against the same block on the CPU,
    on the first MOE_HELD_TOKENS tokens of request 0."""
    import torch
    from repro_torch.models import layers as L
    names = ("w_router", "we1", "we3", "we2")
    w = [params["blocks"][k][0] for k in names]
    xs = x[:1, :MOE_HELD_TOKENS]
    out, aux = L.moe_block(xs, *w, cfg.moe)
    xc, wc = xs.cpu(), [t.cpu() for t in w]
    out_c, aux_c = L.moe_block(xc, *wc, cfg.moe)
    k = cfg.moe.top_k
    idx = L.router_topk(xs[0], w[0], cfg.moe)[0].sort(-1)[0].cpu()
    idx_c = L.router_topk(xc[0], wc[0], cfg.moe)[0].sort(-1)[0]
    probs = torch.softmax(xc[0].float() @ wc[0].float(), -1) \
        .sort(-1, descending=True)[0]
    sure = probs[:, k - 1] - probs[:, k] > MOE_MARGIN
    same = (idx == idx_c).all(-1)
    if not bool(same[sure].all()):
        raise AssertionError(f"[moe] {tag}: expert sets differ where the "
                             f"margin exceeds {MOE_MARGIN}")
    o, oc = out[0].float().cpu(), out_c[0].float()
    rel = float((o - oc)[same].abs().max() / oc.abs().max())
    bits = float((o == oc)[same].float().mean())
    print(f"[moe] {tag} layer 0 MoE block, card vs CPU on "
          f"{MOE_HELD_TOKENS} tokens: expert sets equal for "
          f"{int(same.sum())} of {MOE_HELD_TOKENS} tokens ({int(sure.sum())}"
          f" with a top-{k} margin above {MOE_MARGIN}, all equal); outputs "
          f"of those max|d| {rel:.3g} of max|out| (tolerance {MOE_TOL:.3g}),"
          f" {bits:.4f} bit for bit; aux {float(aux):.6f} vs "
          f"{float(aux_c):.6f}")
    if not rel <= MOE_TOL:
        raise AssertionError(f"[moe] {tag}: MoE block card vs CPU {rel}")
    if not abs(float(aux) - float(aux_c)) <= 1e-5 * abs(float(aux_c)):
        raise AssertionError(f"[moe] {tag}: router loss card vs CPU")


def _moe_meshes() -> list:
    """(label, shape, devices): MOE_MESHES as logical meshes of the card,
    and over the cards where there are several."""
    import torch
    out = [(f"logical {a}x{b}", (a, b), [torch.device("cuda", 0)] * (a * b))
           for a, b in MOE_MESHES]
    n = torch.cuda.device_count()
    for a, b in ((1, 2),) if 2 <= n < 4 else ((2, 2), (1, 4)) if n >= 4 \
            else ():
        out.append((f"{a}x{b} over {a * b} cards", (a, b),
                    [torch.device("cuda", i) for i in range(a * b)]))
    return out


def _moe_expert_parallel(tag: str, params, cfg, x) -> None:
    """``moe_block``'s expert-parallel branch on ``_moe_meshes`` (layer 0's
    experts and MoE input, 2 x 4096 tokens) against its local branch on
    each batch shard's tokens (a shard's capacity counts its own tokens,
    so its drops are the local branch's on those tokens): the same routing
    in every shard (exact), the output within MOE_SHARD_TOL, the aux the
    batch shards' mean; each timed beside the local branch on all."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import shard_ctx
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models import layers as L
    w = [params["blocks"][k][0]
         for k in ("w_router", "we1", "we3", "we2")]
    B, S, d = x.shape
    by_shards = {}
    for nb in sorted({shape[0] for _, shape, _ in _moe_meshes()}):
        outs = [L.moe_block(xb, *w, cfg.moe) for xb in x.chunk(nb)]
        by_shards[nb] = (torch.cat([o for o, _ in outs]),
                         sum(float(a) for _, a in outs) / nb)
    want = L.router_topk(x.reshape(-1, d), w[0], cfg.moe)[0] \
        .reshape(B, S * cfg.moe.top_k)
    local_ms = cuda_ms(lambda: L.moe_block(x, *w, cfg.moe), reps=5,
                       inner=1, warmup=1)
    for label, shape, devs in _moe_meshes():
        mesh = make_mesh(shape, ("data", "model"), devices=devs)
        L.reset_moe_branches()
        for dev in set(devs):
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with _router_inputs() as seen, shard_ctx(mesh, SH.SINGLE_POD_RULES):
            out, aux = L.moe_block(x, *w, cfg.moe)
        for dev in set(devs):
            torch.cuda.synchronize(dev)
        first_ms = (time.perf_counter() - t0) * 1e3
        routed = [r for _, _, r in seen]
        n = shape[0] * shape[1]
        if dict(L.MOE_BRANCHES) != {"expert_parallel": 1, "sorted": n}:
            raise AssertionError(f"[moe] {label}: branches "
                                 f"{dict(L.MOE_BRANCHES)}")
        slices = want.reshape(shape[0], -1)
        if len(routed) != n or not all(
                torch.equal(r.reshape(-1).to(want.device),
                            slices[i // shape[1]])
                for i, r in enumerate(routed)):
            raise AssertionError(f"[moe] {label}: routing differs from the "
                                 "local branch")
        local, aux_want = by_shards[shape[0]]
        rel = _rel_err(out, local)
        with shard_ctx(mesh, SH.SINGLE_POD_RULES):
            ms = cuda_ms(lambda: L.moe_block(x, *w, cfg.moe), reps=5,
                         inner=1, warmup=1)
        print(f"[moe] {tag} expert-parallel {label} (data x model): routing "
              f"exact in all {n} shards, max|d| {rel:.3g} of max|out| vs the"
              f" local branch on the {shape[0]} batch shard(s) (tolerance "
              f"{MOE_SHARD_TOL:.3g}), aux {float(aux):.6f} (their mean "
              f"{aux_want:.6f}); {ms:.3f} ms against the local branch's "
              f"{local_ms:.3f} ms on all {B}x{S} tokens; the first call "
              f"{first_ms:.1f} ms on the host's clock, "
              f"{_kept_gib(params):.3f} GiB of expert slices kept on other "
              f"cards")
        if not rel <= MOE_SHARD_TOL:
            raise AssertionError(f"[moe] {label}: expert-parallel output "
                                 f"{rel}")
        if not abs(float(aux) - aux_want) <= 1e-5 * abs(aux_want):
            raise AssertionError(f"[moe] {label}: aux {float(aux)} vs "
                                 f"{aux_want}")


def _kept_gib(params) -> float:
    """GiB of the parameter copies that ``shard_map_compat`` keeps on the
    stacked weights for shards on other devices."""
    return sum(t.numel() * t.element_size()
               for v in params["blocks"].values()
               for _, t in getattr(v, "_mesh_copies", {}).values()) / 2**30


def phase_moe() -> dict:
    """[moe] (a) qwen2-moe-a2.7b at full width and depth (24 layers, 60
    experts top-4 and a shared expert, 14.0 B parameters drawn on the
    card): :func:`_serve_moe` at 2 x 4096 tokens, every layer's attention
    and prefill + decode held (:func:`_hold_moe_layers`), layer 0's MoE
    block against the CPU (:func:`_hold_moe_block_cpu`); (c) the
    expert-parallel branch on layer 0 (:func:`_moe_expert_parallel`); (b)
    mixtral-8x22b at full width, 2 of its 56 layers: 2 x 8192 tokens
    through the kernel's window form, 32 decode steps past the window on
    the 4096-slot ring, the same holds.  Returns the launches of one
    prefill of each."""
    import torch
    t0 = time.perf_counter()
    arch = _moe_arch("qwen2_moe_a2_7b")
    served = _serve_moe("qwen2-moe", arch, QWEN_SEQ)
    _hold_moe_layers("qwen2-moe", served, arch.cfg, QWEN_SEQ)
    x = _moe_input(served["params"], arch.cfg, served["tokens"])
    _hold_moe_block_cpu("qwen2-moe", served["params"], arch.cfg, x)
    _moe_expert_parallel("qwen2-moe", served["params"], arch.cfg, x)
    launches = {"moe": served["launched"]}
    del served, x
    torch.cuda.empty_cache()
    arch = _moe_arch("mixtral_8x22b", MIXTRAL_LAYERS)
    served = _serve_moe("mixtral", arch, MIXTRAL_SEQ)
    _hold_moe_layers("mixtral", served, arch.cfg, MIXTRAL_SEQ)
    launches["mixtral"] = served["launched"]
    del served
    torch.cuda.empty_cache()
    print(f"[moe] phase wall {time.perf_counter() - t0:.1f} s")
    return launches


def phase_moe_sharded() -> None:
    """[moe] (c) alone: the expert-parallel branch on qwen2-moe-a2.7b's
    layer 0 at full width (a one-layer cut, random weights from seed 0),
    over logical meshes of the card and over the cards where there are
    several (``--moe-sharded``)."""
    import torch
    from repro_torch.configs import ShapeCase
    from repro_torch.launch.steps import materialize
    arch = _moe_arch("qwen2_moe_a2_7b", 1)
    g = torch.Generator(device="cuda").manual_seed(0)
    params, batch = materialize(g, arch, ShapeCase(
        "prefill", "prefill", batch=MOE_BATCH, seq_len=QWEN_SEQ))
    x = _moe_input(params, arch.cfg, batch["tokens"])
    _moe_expert_parallel("qwen2-moe", params, arch.cfg, x)


def phase_profile_moe() -> None:
    """One qwen2-moe-a2.7b prefill of 2x4096 tokens and one decode step
    under torch.profiler, after an unprofiled warm-up of each, in a
    process of its own (``--profile moe``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeCase
    from repro_torch.launch.steps import materialize
    from repro_torch.models import transformer_lm as M
    arch = _moe_arch("qwen2_moe_a2_7b")
    cfg = arch.cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    params, batch = materialize(g, arch, ShapeCase(
        "prefill", "prefill", batch=MOE_BATCH, seq_len=QWEN_SEQ))
    _, kv = M.prefill_step(params, cfg, batch["tokens"])
    cache = M.cache_from_prefill(cfg, kv, QWEN_SEQ + 4)
    tok = batch["tokens"][:, -1:]
    for i in range(2):
        M.decode_step(params, cfg, cache, tok, QWEN_SEQ + i)
    torch.cuda.synchronize()
    for label, run in (
            (f"moe prefill: qwen2-moe {MOE_BATCH}x{QWEN_SEQ} tokens",
             lambda: M.prefill_step(params, cfg, batch["tokens"])),
            (f"moe decode: qwen2-moe, one step of {MOE_BATCH} requests",
             lambda: M.decode_step(params, cfg, cache, tok, QWEN_SEQ + 2))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _print_profile(label, prof, wall, rows_shown=8)


# [zoo]: the vision and diffusion zoo at full published width and depth
ZOO_VISION = ("resnet_50", "resnet_152", "convnext_b", "vit_b16")
ZOO_DIFFUSION = ("dit_b2", "dit_xl2")
ZOO_SERVE_REPS = 10            # timed forwards a vision cell, after a warm-up
ZOO_DIT_REPS = 3               # timed DDIM steps a diffusion cell
ZOO_TRAIN_STEPS = 3            # timed train steps, after one warm-up
# the train batch where the published 256 is cut: DiT-XL/2's step took
# 3.74 s at 256 (H100 80GB HBM3, 700 W), over the ~3 s a step allowed
ZOO_TRAIN_BATCH = {"dit_xl2": 128}
ZOO_TIMESTEPS = (999, 749, 499, 249, 0)    # gen_fast's four DDIM steps
ZOO_REFRESH = 2
# hold 1: a model in bf16 against its own parameters in f32 on the card
# (TF32 off), max|d| over max|f32 output|; top-1 equal or a near tie.
# ViT and DiT hold on parameters drawn by _zoo_hold_specs
ZOO_BF16_SHARE = 0.1
# hold 2: a full-width model cut in depth, f32 on the card against the
# port's CPU path: the convolutional models to f32 sums in another order,
# ViT and DiT also to the bf16 casts of chunked_attention's q, k and v
ZOO_CPU_TOL = {"resnet_50": 1e-4, "convnext_b": 1e-4, "vit_b16": 5e-3,
               "dit_xl2": 5e-3}
ZOO_CUT = {"resnet_50": dict(depths=(1, 1, 1, 1)),
           "convnext_b": dict(depths=(1, 1, 1, 1)),
           "vit_b16": dict(n_layers=2), "dit_xl2": dict(n_layers=2)}
ZOO_CUT_RES = {"resnet_50": 224, "convnext_b": 224, "vit_b16": 224,
               "dit_xl2": 256}


def _zoo_ms(fn, reps: int) -> float:
    """The median host wall in ms of ``reps`` calls after one warm-up,
    each ended by a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _zoo_f32(arch, args):
    """The arch with an f32 config and the parameter tree of ``args``
    cast to f32 (ResNet's ``{"params", "batch_stats"}`` whole)."""
    import dataclasses
    import torch
    from repro_torch.models.params import tree_map
    f32 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype="float32"))
    return f32, tree_map(lambda t: t.to(torch.float32), args)


def _zoo_hold_specs(arch):
    """The arch's parameter specs for the holds: every zero-initialised
    leaf drawn from N(0, 0.02) instead (DiT's adaLN-Zero blocks and final
    layer are otherwise the zero function, output ``final_b`` = 0, and a
    hold on them would be empty), and the attention's q and k kernels
    (``wq``, ``wk``: (L, d, H, Dh)) from N(0, 1/d): the reference's
    fan-in rule takes H for their fan-in, which gives scores of std ~64,
    a softmax that is a hard argmax, and a pick that one bf16 ulp (or an
    f32 sum in another order) flips.  At 1/d the scores have std ~1."""
    import dataclasses
    import math
    from repro_torch.launch import steps as S
    from repro_torch.models.params import ParamSpec

    def one(s, name=""):
        if not isinstance(s, ParamSpec):
            return {k: one(v, k) for k, v in s.items()}
        if s.init == "zeros":
            return dataclasses.replace(s, init="normal")
        if name in ("wq", "wk"):
            return dataclasses.replace(s, init="normal",
                                       scale=1 / math.sqrt(s.shape[1]))
        return s
    return one(S._model(arch).param_specs(arch.cfg))


def _zoo_serve_vision(arch_id: str, card: str) -> None:
    """serve_b1 and serve_b128 of one vision arch through
    ``make_infer_fn``: median ms of ZOO_SERVE_REPS, images/s, peak
    memory; hold 1 at serve_b1."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_infer_fn, materialize
    from repro_torch.models.params import init_params
    arch = get_arch(arch_id)
    g = torch.Generator(device="cuda").manual_seed(0)
    big = arch.shapes["serve_b128"]
    params, batch = materialize(g, arch, big)
    for name, b in (("serve_b1", {"images": batch["images"][:1]}),
                    ("serve_b128", batch)):
        case = arch.shapes[name]
        fn = make_infer_fn(arch, case)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        ms = _zoo_ms(lambda: fn(params, b), ZOO_SERVE_REPS)
        logits = fn(params, b)
        _expect_launches(f"[zoo] {arch_id} {name}", {})
        if logits.shape != (case.batch, arch.cfg.n_classes) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[zoo] {arch_id} {name}: bad logits")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[zoo] {arch_id} {name}: median {ms:.3f} ms of "
              f"{ZOO_SERVE_REPS}, {case.batch * 1e3 / ms:.1f} images/s, "
              f"peak {peak:.2f} GiB ({card})")
    # hold 1: the same parameters in f32, the same port code (ViT's drawn
    # by _zoo_hold_specs)
    if arch_id == "vit_b16":
        dev = batch["images"].device
        params = init_params(torch.Generator(device=dev).manual_seed(1),
                             _zoo_hold_specs(arch), dev)
    f32, p32 = _zoo_f32(arch, params)
    one = {"images": batch["images"][:1]}
    got = make_infer_fn(arch, arch.shapes["serve_b1"])(params, one)
    ref = make_infer_fn(f32, f32.shapes["serve_b1"])(p32, one)
    _hold_logits(f"{arch_id} serve_b1 bf16 vs f32", got, ref, phase="zoo",
                 tol=ZOO_BF16_SHARE)


def _zoo_serve_dit(arch_id: str, card: str) -> None:
    """One DDIM step of one DiT at gen_fast and gen_1024 through
    ``make_infer_fn`` (median of ZOO_DIT_REPS after a warm-up); then
    ``sample_with_cache`` over gen_fast's four steps refreshing every
    ZOO_REFRESH steps against four fresh steps (the forwards counted);
    hold 1 at B = 1 of gen_fast's size, on parameters drawn by
    :func:`_zoo_hold_specs`."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_infer_fn, materialize
    from repro_torch.models import dit as DIT
    from repro_torch.models.params import init_params
    arch = get_arch(arch_id)
    cfg = arch.cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in ("gen_1024", "gen_fast"):
        case = arch.shapes[name]
        params, batch = materialize(g, arch, case)
        fn = make_infer_fn(arch, case)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        ms = _zoo_ms(lambda: fn(params, batch), ZOO_DIT_REPS)
        x = fn(params, batch)
        _expect_launches(f"[zoo] {arch_id} {name}", {})
        if x.shape != batch["xt"].shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"[zoo] {arch_id} {name}: bad step output")
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = cfg.n_tokens(case.img_res)
        print(f"[zoo] {arch_id} {name}: one ddim_step of {case.batch} x "
              f"{tokens} tokens, median {ms:.3f} ms of {ZOO_DIT_REPS}, "
              f"{case.batch * 1e3 / ms:.2f} images/s a step, peak "
              f"{peak:.2f} GiB ({card})")
    fast = batch                     # gen_fast's, with its parameters
    # the step cache: refresh every ZOO_REFRESH steps against every step
    calls = []
    forward = DIT.forward

    def counted(*a):
        calls.append(1)
        return forward(*a)
    DIT.forward = counted
    try:
        walls = {}
        with torch.no_grad():
            for every in (1, ZOO_REFRESH):
                del calls[:]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                xs = DIT.sample_with_cache(params, cfg, fast["xt"],
                                           ZOO_TIMESTEPS, fast["y"],
                                           refresh_every=every)
                torch.cuda.synchronize()
                walls[every] = ((time.perf_counter() - t0) * 1e3,
                                len(calls))
                if not bool(torch.isfinite(xs).all()):
                    raise AssertionError(f"[zoo] {arch_id} sample: not "
                                         "finite")
    finally:
        DIT.forward = forward
    n = len(ZOO_TIMESTEPS) - 1
    if walls[1][1] != n or walls[ZOO_REFRESH][1] != -(-n // ZOO_REFRESH):
        raise AssertionError(f"[zoo] {arch_id} sample: forwards {walls}")
    print(f"[zoo] {arch_id} gen_fast sample_with_cache over {n} steps: "
          f"refresh every {ZOO_REFRESH}: {walls[ZOO_REFRESH][0]:.1f} ms, "
          f"{walls[ZOO_REFRESH][1]} forwards; every step: "
          f"{walls[1][0]:.1f} ms, {walls[1][1]} forwards ({card})")
    # hold 1, on parameters drawn by _zoo_hold_specs
    del params
    torch.cuda.empty_cache()
    dev = fast["xt"].device
    drawn = init_params(torch.Generator(device=dev).manual_seed(1),
                        _zoo_hold_specs(arch), dev)
    f32, p32 = _zoo_f32(arch, drawn)
    xt, t, tp, y = (fast[k][:1] for k in ("xt", "t", "t_prev", "y"))
    with torch.no_grad():
        got = DIT.ddim_step(drawn, cfg, xt, t, tp, y)
        ref = DIT.ddim_step(p32, f32.cfg, xt, t, tp, y)
        eps = DIT.forward(drawn, cfg, xt, t, y)
        eps32 = DIT.forward(p32, f32.cfg, xt, t, y)
    for tag, a, b in (("eps", eps, eps32), ("ddim_step", got, ref)):
        rel = _rel_err(a, b)
        print(f"[zoo] {arch_id} gen_fast B=1 {tag} bf16 vs f32: max|d| "
              f"{float((a - b).abs().max()):.4g} = {rel:.4g} of "
              f"max|f32| {float(b.abs().max()):.4g} (tolerance "
              f"{ZOO_BF16_SHARE})")
        if not rel <= ZOO_BF16_SHARE:
            raise AssertionError(f"[zoo] {arch_id} {tag}: bf16 and f32 "
                                 f"disagree ({rel})")


def _zoo_train(arch_id: str, card: str) -> None:
    """ZOO_TRAIN_STEPS steps of ``make_train_fn`` after one warm-up, at
    cls_224 (vision) or train_256 (diffusion), the published batch unless
    ZOO_TRAIN_BATCH cuts it: step ms, images/s, peak memory and the
    losses (finite); ResNet's batch_stats must move."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_train_fn, materialize
    from repro_torch.models.params import tree_leaves
    arch = get_arch(arch_id)
    name = "train_256" if arch.family == "diffusion" else "cls_224"
    case = arch.shapes[name]
    if arch_id in ZOO_TRAIN_BATCH:
        print(f"[zoo] {arch_id} {name}: batch cut from {case.batch} to "
              f"{ZOO_TRAIN_BATCH[arch_id]}")
        case = dataclasses.replace(case, batch=ZOO_TRAIN_BATCH[arch_id])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(0)
    state, batch = materialize(g, arch, case)
    stats0 = [t.clone() for t in tree_leaves(state.get("batch_stats", {}))]
    step = make_train_fn(arch, case.grad_accum)
    losses, times = [], []
    build.reset_launches()
    for _ in range(ZOO_TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))          # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    _expect_launches(f"[zoo] {arch_id} {name}", {})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[zoo] {arch_id} {name}: losses {losses}")
    if stats0 and all(torch.equal(a, b) for a, b in
                      zip(stats0, tree_leaves(state["batch_stats"]))):
        raise AssertionError(f"[zoo] {arch_id}: batch_stats did not move")
    ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[zoo] {arch_id} {name} train: batch {case.batch}, step "
          f"{ms:.1f} ms (median of {ZOO_TRAIN_STEPS} after a warm-up of "
          f"{times[0]:.1f} ms), {case.batch * 1e3 / ms:.1f} images/s, peak "
          f"{peak:.2f} GiB, losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}"
          f"{', batch_stats moved' if stats0 else ''} ({card})")


def _zoo_cut_vs_cpu(arch_id: str) -> None:
    """Hold 2: the full-width arch cut in depth (ZOO_CUT), f32, on the
    card against the port's CPU path on the same parameters (drawn on the
    CPU by :func:`_zoo_hold_specs`, ResNet's running means too) and
    inputs, B = 1."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_infer_fn
    from repro_torch.models.params import init_params, tree_map
    base = get_arch(arch_id)
    arch = dataclasses.replace(base, cfg=dataclasses.replace(
        base.cfg, dtype="float32", **ZOO_CUT[arch_id]))
    cpu = torch.device("cpu")
    params = init_params(torch.Generator().manual_seed(2),
                         _zoo_hold_specs(arch), cpu)
    g = torch.Generator().manual_seed(3)
    res = ZOO_CUT_RES[arch_id]
    if arch.family == "diffusion":
        lr = arch.cfg.latent_res(res)
        t, tp = torch.full((1,), 500), torch.full((1,), 480)
        batch = {"xt": torch.randn(1, lr, lr, 4, generator=g), "t": t,
                 "t_prev": tp, "y": torch.zeros(1, dtype=torch.int32)}
        case = arch.shapes["gen_fast"]
    else:
        batch = {"images": torch.randn(1, res, res, 3, generator=g)}
        case = arch.shapes["serve_b1"]
    fn = make_infer_fn(arch, case)
    ref = fn(params, batch)
    got = fn(tree_map(lambda a: a.cuda(), params),
             {k: v.cuda() for k, v in batch.items()}).cpu()
    rel = _rel_err(got, ref)
    tol = ZOO_CPU_TOL[arch_id]
    cut = ", ".join(f"{k}={v}" for k, v in ZOO_CUT[arch_id].items())
    print(f"[zoo] {arch_id} ({cut}, f32, {res} px) card vs CPU: max|d| "
          f"{float((got - ref).abs().max()):.4g} = {rel:.4g} of max|CPU| "
          f"{float(ref.abs().max()):.4g} (tolerance {tol})")
    if not rel <= tol:
        raise AssertionError(f"[zoo] {arch_id}: card and CPU disagree "
                             f"({rel})")


def phase_zoo(card: str) -> None:
    """[zoo] the six vision and diffusion configs at full published width
    and depth, bf16, the reference's init rule from seeded generators:
    serving (:func:`_zoo_serve_vision`, :func:`_zoo_serve_dit`), training
    (:func:`_zoo_train`), and the holds (1: bf16 against f32 on the card,
    in the serving functions; 2: :func:`_zoo_cut_vs_cpu`).  No kernel of
    the port is on these paths (the reference's zoo reaches no Pallas
    kernel), which every serve and train call checks."""
    import torch
    t0 = time.perf_counter()
    for arch_id in ZOO_VISION:
        _zoo_serve_vision(arch_id, card)
        torch.cuda.empty_cache()
    for arch_id in ZOO_DIFFUSION:
        _zoo_serve_dit(arch_id, card)
        torch.cuda.empty_cache()
    for arch_id in (*ZOO_VISION, *ZOO_DIFFUSION):
        _zoo_train(arch_id, card)
        torch.cuda.empty_cache()
    for arch_id in ZOO_CUT:
        _zoo_cut_vs_cpu(arch_id)
    print(f"[zoo] phase wall {time.perf_counter() - t0:.1f} s")


def phase_profile_zoo() -> None:
    """ResNet-50 at serve_b128 and one DiT-XL/2 DDIM step at gen_fast
    under torch.profiler, after an unprofiled warm-up of each, in a
    process of its own (``--profile zoo``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_infer_fn, materialize
    runs = []
    for arch_id, name in (("resnet_50", "serve_b128"),
                          ("dit_xl2", "gen_fast")):
        arch = get_arch(arch_id)
        case = arch.shapes[name]
        params, batch = materialize(
            torch.Generator(device="cuda").manual_seed(0), arch, case)
        fn = make_infer_fn(arch, case)
        runs.append((f"zoo {arch_id} {name}: batch {case.batch}",
                     lambda fn=fn, p=params, b=batch: fn(p, b)))
    for _, run in runs:
        run()
    torch.cuda.synchronize()
    for label, run in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _print_profile(label, prof, wall, rows_shown=10)


def _streams(n: int = 2):
    """The reference's paper_stream_mix of n streams (even ones sparse,
    odd ones dense), object sizes and speeds scaled from its 96-px frames
    to 720 px."""
    import dataclasses
    from repro_torch.sim.video_source import paper_stream_mix
    k = H_HD / 96
    return [dataclasses.replace(sc, min_size=int(sc.min_size * k),
                                max_size=int(sc.max_size * k),
                                speed=sc.speed * k)
            for sc in paper_stream_mix(n, H_HD, W_HD)]


# seq_sum launches a chunk, for any number of streams: the encode's bits and
# its two features (2), the video bits, the anchors' bits and their total
SEQ_SUMS = 5


def path_configs(det_cfg) -> dict:
    """The paths this script drives: tag -> (RoundtripConfig, the launches
    each chunk must make of each kernel form; 0 for a form not named)."""
    from repro_torch.codec.video_codec import VideoCodecConfig
    from repro_torch.core.roi import RoiConfig
    from repro_torch.core.roundtrip import RoundtripConfig
    return {
        "main": (RoundtripConfig(level=LEVEL, det_cfg=det_cfg),
                 {"motion_sad": T - 1, "blockdct_forward": T + 1,
                  "blockdct_inverse": 1, "qtransfer": T,
                  "seq_sum": SEQ_SUMS}),
        "roi": (RoundtripConfig(level=LEVEL, det_cfg=det_cfg,
                                codec=VideoCodecConfig(**ROI_CODEC),
                                roi=RoiConfig(**ROI)),
                {"motion_sad_diamond_bf16": T - 1, "roi_gather": 1,
                 "blockdct_forward": T + 1, "blockdct_inverse": 1,
                 "qtransfer": T, "seq_sum": SEQ_SUMS})}


def run_paths(params, paths: dict) -> dict:
    """2 streams x 3 consecutive chunks through ``roundtrip_chunk`` on
    every path, the paths in turns chunk by chunk so that they share the
    host's state: per-chunk time, frames/s and pipeline mix.  The launch
    counts are set to 0 just before each chunk and read just after it;
    each path must make its expected launches per chunk.  Returns each
    path's launch counts, summed over its chunks."""
    import collections
    import torch
    from repro_torch.core.roundtrip import roundtrip_chunk
    from repro_torch.kernels import build
    from repro_torch.sim.video_source import generate_chunk
    inputs = [[generate_chunk(sc, c * T, T) for c in range(3)]
              for sc in _streams()]
    torch.cuda.synchronize()
    chunk_ms = {tag: [] for tag in paths}
    launches = {tag: collections.Counter() for tag in paths}
    peak = dict.fromkeys(paths, 0)
    mallocs = dict.fromkeys(paths, 0)     # cudaMalloc calls, steady chunks
    for s, chunks in enumerate(inputs):
        for c, (raw, gtb, gtv) in enumerate(chunks):
            for tag, (cfg, per_chunk) in paths.items():
                torch.cuda.reset_peak_memory_stats()
                n_alloc = torch.cuda.memory_stats().get("num_device_alloc", 0)
                build.reset_launches()
                t0 = time.perf_counter()
                out = roundtrip_chunk(raw, gtb, gtv, params, tr1=TR1,
                                      tr2=TR2, bw_kbps=6000.0, cfg=cfg)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                got = dict(build.LAUNCHES)
                if s or c:
                    mallocs[tag] += torch.cuda.memory_stats().get(
                        "num_device_alloc", 0) - n_alloc
                peak[tag] = max(peak[tag], torch.cuda.max_memory_allocated())
                chunk_ms[tag].append(dt)
                launches[tag].update(got)
                _expect_launches(f"[{tag}] stream {s} chunk {c}", per_chunk)
                types = out["types"]
                for k, v in out.items():
                    if v.is_floating_point() \
                            and not bool(torch.isfinite(v).all()):
                        raise AssertionError(f"[{tag}] stream {s} chunk {c}:"
                                             f" {k} is not finite")
                if int(types[0]) != 1 or out["boxes"].shape != (
                        T, (H_HD // 8) * (W_HD // 8), 4):
                    raise AssertionError(
                        f"[{tag}] stream {s} chunk {c}: bad output (types[0]"
                        f"={int(types[0])}, boxes "
                        f"{tuple(out['boxes'].shape)})")
                mix = [int((types == k).sum()) for k in (1, 2, 3)]
                print(f"[{tag}] stream {s} chunk {c}: {dt:.1f} ms "
                      f"({T / dt * 1e3:.1f} frames/s), pipelines {mix}, "
                      f"mean_f1 {float(out['mean_f1']):.4f}, bits "
                      f"{float(out['total_bits']):.0f}, latency "
                      f"{float(out['latency']):.4f} s")
    for tag, ms in chunk_ms.items():
        n = len(ms)
        print(f"[{tag}] launches over {n} chunks: {dict(launches[tag])}; "
              f"per chunk: { {k: v / n for k, v in launches[tag].items()} }")
        # the first chunk pays for the warm-up (cuDNN's plans, the
        # allocator): the median of the rest is the steady state
        steady = statistics.median(ms[1:])
        print(f"[{tag}] {n} chunks of {T}x{H_HD}x{W_HD}: first {ms[0]:.1f} "
              f"ms, median of the rest {steady:.1f} ms "
              f"({T / steady * 1e3:.1f} frames/s), peak device memory "
              f"{peak[tag] / 2**30:.2f} GiB, {mallocs[tag]} cudaMalloc calls "
              f"in the steady chunks")
    return {tag: dict(n) for tag, n in launches.items()}


def phase_profile(tag: str, params, cfg) -> None:
    """One steady-state chunk of the dense stream under torch.profiler,
    after two unprofiled chunks: host wall time, device busy time and
    share, device ops, the device time by kernel and the host time by
    operator.  Run in a process of its own (``--profile TAG``): once the
    profiler has run, the host runs every operator of the process more
    slowly."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.roundtrip import roundtrip_chunk
    from repro_torch.sim.video_source import generate_chunk
    warm = []
    for c in (1, 2, 3):
        raw, gtb, gtv = generate_chunk(_streams()[1], c * T, T)
        torch.cuda.synchronize()
        if c < 3:
            t0 = time.perf_counter()
            roundtrip_chunk(raw, gtb, gtv, params, tr1=TR1, tr2=TR2,
                            bw_kbps=6000.0, cfg=cfg)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] {tag}: alone in a process, unprofiled chunks "
          f"{', '.join(f'{ms:.1f}' for ms in warm)} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        roundtrip_chunk(raw, gtb, gtv, params, tr1=TR1, tr2=TR2,
                        bw_kbps=6000.0, cfg=cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _print_profile(f"{tag}: one chunk {T}x{H_HD}x{W_HD}", prof, wall)


# the __global__ functions of the port's kernel sources
PORT_KERNELS = ("motion_sad_exhaustive_kernel", "motion_sad_diamond_kernel",
                "forward_quant_kernel", "inverse_kernel",
                "qtransfer_kernel", "roi_gather_kernel", "flash_fwd_kernel",
                "seq_sum_kernel")


def _print_profile(label: str, prof, wall: float, rows_shown: int = 12):
    """Wall time, device busy time and share, device ops, the device time
    by kernel and the host time by operator of one profiled window."""
    import torch
    # the device-side events (kernels, copies, fills); the host ops that
    # launched them carry the same time and are left out
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    n = sum(r[1] for r in rows)
    tag = label.split(":")[0]
    print(f"[profile] {label}: wall {wall:.1f} ms, device busy {busy:.2f} "
          f"ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), {n} device ops")
    rows.sort(reverse=True)
    for ms, count, key in rows[:rows_shown]:
        print(f"[profile]   {ms:8.3f} ms  {count:5d}x  {key[:90]}")
    # and the port's own kernels further down
    for ms, count, key in rows[rows_shown:]:
        if any(k in key for k in PORT_KERNELS):
            print(f"[profile]   {ms:8.3f} ms  {count:5d}x  {key[:90]}")
    # the host side: the operators' own CPU time, which is most of the wall
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)
    print(f"[profile] {tag}: host self time {sum(r[0] for r in host):.2f} "
          f"ms over {sum(r[1] for r in host)} host ops; the largest:")
    for ms, count, key in host[:10]:
        print(f"[profile]   host {ms:8.3f} ms  {count:5d}x  {key[:80]}")


def phase_profile_lm() -> None:
    """One llama3.2-1B prefill of 2x4096 tokens and one decode step under
    torch.profiler, after an unprofiled warm-up of each, in a process of
    its own (``--profile lm``)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeCase, get_arch
    from repro_torch.launch.steps import materialize
    from repro_torch.models import transformer_lm as M
    base = get_arch("llama3_2_1b")
    arch = dataclasses.replace(base, cfg=dataclasses.replace(
        base.cfg, attention_impl="pallas"))
    cfg = arch.cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    params, batch = materialize(g, arch, ShapeCase(
        "prefill_4k", "prefill", batch=LM_BATCH, seq_len=LM_SEQ))
    _, kv = M.prefill_step(params, cfg, batch["tokens"])
    cache = M.cache_from_prefill(cfg, kv, LM_SEQ + 4)
    tok = batch["tokens"][:, -1:]
    for i in range(2):
        M.decode_step(params, cfg, cache, tok, LM_SEQ + i)
    torch.cuda.synchronize()
    for label, run in (
            (f"lm prefill: {LM_BATCH}x{LM_SEQ} tokens",
             lambda: M.prefill_step(params, cfg, batch["tokens"])),
            (f"lm decode: one step of {LM_BATCH} requests",
             lambda: M.decode_step(params, cfg, cache, tok, LM_SEQ + 2))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _print_profile(label, prof, wall, rows_shown=8)


def phase_admit_all(params, cfg) -> None:
    """The gate admitting all 144 regions must reproduce the ungated
    detector on a full-width chunk, within the [parity] tolerances (cuDNN
    may pick another algorithm for the patch batch than for the frame)."""
    import dataclasses
    import torch
    from repro_torch.core.roi import RoiConfig
    from repro_torch.core.roundtrip import roundtrip_chunk
    from repro_torch.sim.video_source import generate_chunk
    raw, gtb, gtv = generate_chunk(_streams()[0], 0, T)
    n_regions = (H_HD // ROI["region_px"]) * (W_HD // ROI["region_px"])
    every = dataclasses.replace(cfg, roi=RoiConfig(**dict(
        ROI, capacity=n_regions, threshold=-1.0)))
    kw = dict(tr1=TR1, tr2=TR2, bw_kbps=6000.0)
    gated = roundtrip_chunk(raw, gtb, gtv, params, cfg=every, **kw)
    full = roundtrip_chunk(raw, gtb, gtv, params,
                           cfg=dataclasses.replace(cfg, roi=None), **kw)
    if not torch.equal(gated["types"], full["types"]):
        raise AssertionError("admit-all: frame types differ")
    torch.testing.assert_close(gated["scores"], full["scores"], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(gated["boxes"], full["boxes"], rtol=0,
                               atol=1e-2)
    print(f"[roi] admit-all ({n_regions} of {n_regions} regions) == ungated "
          f"on {T}x{H_HD}x{W_HD}: max |dscore| "
          f"{float((gated['scores'] - full['scores']).abs().max()):.3g}, max "
          f"|dbox| {float((gated['boxes'] - full['boxes']).abs().max()):.3g}")


def phase_small_parity(params, det_cfg) -> dict:
    """64x96 chunks through the kernels on the card against the port's
    plain path on the CPU (the contract of tests/test_torch_roundtrip.py):
    the default config at two rungs and two threshold pairs, then every
    codec variant with and without the ROI gate.  Returns the launch
    counts of the card runs."""
    import torch
    from repro_torch.codec.video_codec import VideoCodecConfig
    from repro_torch.core.roi import RoiConfig
    from repro_torch.core.roundtrip import RoundtripConfig, roundtrip_chunk
    from repro_torch.kernels import build
    from repro_torch.sim.video_source import StreamConfig, generate_chunk
    raw, gtb, gtv = generate_chunk(
        StreamConfig(height=64, width=96, n_objects=3, seed=0), 0, 4,
        device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    runs = [(f"level {level} tr=({tr1},{tr2})", (tr1, tr2),
             RoundtripConfig(level=level, det_cfg=det_cfg))
            for level in (2, 3) for tr1, tr2 in ((0.05, 0.1), (0.5, 0.02))]
    runs += [(f"level 2 {search} {dtype} roi={roi is not None}", (0.5, 0.02),
              RoundtripConfig(level=2, det_cfg=det_cfg, roi=roi,
                              codec=VideoCodecConfig(search=search,
                                                     dtype=dtype)))
             for search in ("exhaustive", "diamond")
             for dtype in ("float32", "bfloat16")
             for roi in (None, RoiConfig(capacity=3))]
    build.reset_launches()
    for label, (tr1, tr2), cfg in runs:
        kw = dict(tr1=tr1, tr2=tr2, bw_kbps=6000.0, cfg=cfg)
        gpu = roundtrip_chunk(raw, gtb, gtv, params, **kw)
        cpu = roundtrip_chunk(raw, gtb, gtv, cpu_params, device="cpu", **kw)
        g = {k: v.cpu() for k, v in gpu.items()}
        if not torch.equal(g["types"], cpu["types"]) \
                or not torch.equal(g["anchor_q"], cpu["anchor_q"]):
            raise AssertionError(f"small parity {label}: types "
                                 f"{g['types'].tolist()} vs "
                                 f"{cpu['types'].tolist()}")
        for k, kwt in (("total_bits", dict(rtol=1e-4, atol=0)),
                       ("scores", dict(rtol=0, atol=1e-4)),
                       ("boxes", dict(rtol=0, atol=1e-2)),
                       ("latency", dict(rtol=1e-5, atol=0))):
            torch.testing.assert_close(g[k], cpu[k], **kwt)
        print(f"[parity] 64x96 T=4 {label}: card == CPU plain path (types "
              f"{g['types'].tolist()})")
    launches = dict(build.LAUNCHES)
    print(f"[parity] launches over {len(runs)} chunks: {launches}")
    return launches


# [batched]: the paper's nine 30 fps cameras on one card, at mixed rungs
BATCHED_STREAMS = 9
BATCHED_LEVELS = (0, 1, 2, 3, 4, 0, 1, 2, 3)
BATCHED_CHUNKS = 3
FLOOR_FPS = 270.0             # nine real-time streams (PERF.md section 2)
# the launches a chunk of each kernel form, whatever the number of streams
MAIN_LAUNCHES = {"motion_sad": T - 1, "blockdct_forward": T + 1,
                 "blockdct_inverse": 1, "qtransfer": T, "seq_sum": SEQ_SUMS}
ROI_LAUNCHES = {"motion_sad_diamond_bf16": T - 1, "roi_gather": 1,
                "blockdct_forward": T + 1, "blockdct_inverse": 1,
                "qtransfer": T, "seq_sum": SEQ_SUMS}
# with the budget search the anchors take one forward a rung and one at the
# chosen rungs, and seq_sum the six rungs' bits (in place of the pinned
# anchors') and the anchor count
SEARCH_LAUNCHES = dict(MAIN_LAUNCHES, blockdct_forward=T + 6 + 1,
                       seq_sum=SEQ_SUMS + 6)
# floats of a batched lane against its single-stream run: the [parity]
# tolerances (cuDNN may take another algorithm for 270 frames than for 30)
LANE_TOL = {"total_bits": dict(rtol=1e-4, atol=0),
            "video_bits": dict(rtol=1e-4, atol=0),
            "anchor_bits": dict(rtol=1e-4, atol=0),
            "scores": dict(rtol=0, atol=1e-4), "boxes": dict(rtol=0, atol=1e-2),
            "f1": dict(rtol=0, atol=1e-6), "mean_f1": dict(rtol=0, atol=1e-6),
            "latency": dict(rtol=1e-5, atol=0),
            "t_trans": dict(rtol=1e-5, atol=0),
            "t_comp": dict(rtol=0, atol=0), "t_queue": dict(rtol=0, atol=0)}


def _batched_chunks():
    """BATCHED_CHUNKS consecutive chunks of the nine streams, rendered by
    ``generate_chunk_batched`` a signature group at a time; ground truth
    padded to the densest stream's object count (the pad invalid)."""
    import torch
    from repro_torch.sim.video_source import (generate_chunk_batched,
                                              group_by_signature)
    mix = _streams(BATCHED_STREAMS)
    n_max = max(sc.n_objects for sc in mix)
    chunks = []
    for c in range(BATCHED_CHUNKS):
        raw = torch.empty((len(mix), T, H_HD, W_HD), device="cuda")
        gtb = torch.zeros((len(mix), T, n_max, 4), device="cuda")
        gtv = torch.zeros((len(mix), T, n_max), dtype=torch.bool,
                          device="cuda")
        for (_, _, n), idx in group_by_signature(mix).items():
            f, b, v = generate_chunk_batched([mix[i] for i in idx], c * T, T)
            raw[idx], gtb[idx, :, :n], gtv[idx, :, :n] = f, b, v
        chunks.append((raw, gtb, gtv))
    torch.cuda.synchronize()
    return mix, chunks


def _hold_lanes(tag: str, out: dict, singles: list) -> None:
    """Each lane of a batched run against its stream's single-stream run:
    the frame types and anchor qualities exactly, the floats bit for bit
    or within LANE_TOL; prints how many lanes were bit for bit equal."""
    import torch
    equal, differ = 0, set()
    for s, one in enumerate(singles):
        if set(out) != set(one):
            raise AssertionError(f"[batched] {tag}: keys differ")
        for k in ("types", "anchor_q"):
            if not torch.equal(out[k][s], one[k]):
                raise AssertionError(f"[batched] {tag} lane {s}: {k} "
                                     f"{out[k][s].tolist()} vs "
                                     f"{one[k].tolist()}")
        keys = [k for k in one if not torch.equal(out[k][s], one[k])]
        for k in keys:
            torch.testing.assert_close(out[k][s], one[k], **LANE_TOL[k],
                                       msg=f"[batched] {tag} lane {s}: {k}")
        equal += not keys
        differ.update(keys)
    print(f"[batched] {tag}: {equal} of {len(singles)} lanes bit for bit "
          f"the single-stream run; the others within the [parity] "
          f"tolerances in {sorted(differ) or 'nothing'}; frame types and "
          "anchor qualities exact")


def _batched_bandwidths(raw, out) -> list:
    """A bandwidth a stream (kbps) at which its anchors' even share of the
    spare bits is the median of their bits at rung 3: some anchors fit
    rung 3 and some do not, so the search picks several rungs."""
    import torch
    from repro_torch.codec.image_codec import ladder_bits
    bws = []
    for s in range(raw.shape[0]):
        anchors = torch.nonzero(out["types"][s] == 1).flatten()
        target = float(ladder_bits(raw[s, anchors])[:, 3].median())
        bws.append((target * len(anchors) + float(out["video_bits"][s]))
                   / (1000.0 * T / 30.0))
    return bws


def phase_batched(params, det_cfg) -> dict:
    """[batched]: nine streams of paper_stream_mix(9) at 720p, three chunks,
    in five runs: (1) roundtrip_batched at rung 2 and (2) nine
    roundtrip_chunk calls on the same chunks, in turns; (3)
    roundtrip_ladder_batched at BATCHED_LEVELS; (4) roundtrip_padded_batched
    on the full LR canvas with the [roi] gate; (5) (1) with the budget
    search at bandwidths that make it pick several rungs.  Each run's
    launches a chunk must be a single stream's; its lanes are held against
    the single-stream runs.  Returns each run's launch counts."""
    import collections
    import dataclasses
    import torch
    from repro_torch.codec.rate_model import (QUALITY_LADDER, downscale,
                                              ladder_lr_shape)
    from repro_torch.codec.video_codec import VideoCodecConfig
    from repro_torch.core.roi import RoiConfig
    from repro_torch.core import roundtrip as RT
    from repro_torch.kernels import build
    mix, chunks = _batched_chunks()
    S = len(mix)
    main = RT.RoundtripConfig(level=LEVEL, det_cfg=det_cfg)
    roi = dataclasses.replace(main, codec=VideoCodecConfig(**ROI_CODEC),
                              roi=RoiConfig(**ROI))
    search = dataclasses.replace(main, anchor_search=True)
    kw = dict(tr1=TR1, tr2=TR2, queue_delay=0.0)
    hp, wp = RT.full_lr_canvas(H_HD, W_HD)

    def padded(raw, gtb, gtv, cfg, **k):
        lr_pad = torch.stack([torch.nn.functional.pad(
            downscale(raw[s], QUALITY_LADDER[level].scale),
            (0, wp - w, 0, hp - h)) for s, (level, (h, w)) in enumerate(
                (lv, ladder_lr_shape(lv, H_HD, W_HD))
                for lv in BATCHED_LEVELS)])
        ext, qual = RT.ladder_batch_arrays(BATCHED_LEVELS, H_HD, W_HD)
        return RT.roundtrip_padded_batched(raw, lr_pad, ext, qual, gtb, gtv,
                                           params, cfg=cfg, **k)

    def sequential(raw, gtb, gtv, cfg, bw_kbps, levels=None):
        return [RT.roundtrip_chunk(
            raw[s], gtb[s], gtv[s], params, cfg=cfg if levels is None else
            dataclasses.replace(cfg, level=levels[s]), bw_kbps=bw_kbps[s],
            **kw) for s in range(S)]

    bw = [6000.0] * S
    runs = {
        "batched": (MAIN_LAUNCHES, lambda r, b, v, bw: RT.roundtrip_batched(
            r, b, v, params, cfg=main, bw_kbps=bw, **kw)),
        "sequential": ({k: S * n for k, n in MAIN_LAUNCHES.items()},
                       lambda r, b, v, bw: sequential(r, b, v, main, bw)),
        "ladder": (MAIN_LAUNCHES, lambda r, b, v, bw:
                   RT.roundtrip_ladder_batched(
                       r, b, v, params, levels=BATCHED_LEVELS, cfg=main,
                       bw_kbps=bw, **kw)),
        "padded_roi": (ROI_LAUNCHES, lambda r, b, v, bw: padded(
            r, b, v, roi, bw_kbps=bw, **kw)),
        "search": (SEARCH_LAUNCHES, lambda r, b, v, bw: RT.roundtrip_batched(
            r, b, v, params, cfg=search, bw_kbps=bw, **kw)),
    }
    ms = {tag: [] for tag in runs}
    launches = {tag: collections.Counter() for tag in runs}
    peak = dict.fromkeys(runs, 0)
    outs = {}
    for tag, (per_chunk, run) in runs.items():
        if tag == "search":
            bw = _batched_bandwidths(chunks[0][0], outs["batched"][0])
            print(f"[batched] search: bandwidths a stream "
                  f"{[round(b, 1) for b in bw]} kbps")
        # (1) and (2) in turns, chunk by chunk
        order = [] if tag == "sequential" else [tag] + (
            ["sequential"] if tag == "batched" else [])
        for c, (raw, gtb, gtv) in enumerate(chunks):
            for t in order:
                torch.cuda.reset_peak_memory_stats()
                build.reset_launches()
                t0 = time.perf_counter()
                out = runs[t][1](raw, gtb, gtv, bw)
                torch.cuda.synchronize()
                ms[t].append((time.perf_counter() - t0) * 1e3)
                peak[t] = max(peak[t], torch.cuda.max_memory_allocated())
                launches[t].update(build.LAUNCHES)
                _expect_launches(f"[batched] {t} chunk {c}", runs[t][0])
                outs.setdefault(t, []).append(out)
        if tag == "sequential":
            continue
        for out in outs[tag]:
            for k, v in out.items():
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"[batched] {tag}: {k} not finite")
            if out["boxes"].shape != (S, T, (H_HD // 8) * (W_HD // 8), 4) \
                    or not bool((out["types"][:, 0] == 1).all()):
                raise AssertionError(f"[batched] {tag}: bad output")
        mix_ = [[int((outs[tag][0]["types"][s] == k).sum()) for k in (1, 2, 3)]
                for s in range(S)]
        print(f"[batched] {tag} chunk 0 pipelines by stream: {mix_}")

    # each run's lanes against the single-stream path
    for c in range(BATCHED_CHUNKS):
        seq = outs["sequential"][c]
        _hold_lanes(f"batched chunk {c} vs 9 roundtrip_chunk calls",
                    outs["batched"][c], seq)
    raw, gtb, gtv = chunks[0]
    _hold_lanes("ladder chunk 0", outs["ladder"][0], sequential(
        raw, gtb, gtv, main, [6000.0] * S, BATCHED_LEVELS))
    _hold_lanes("padded_roi chunk 0", outs["padded_roi"][0], sequential(
        raw, gtb, gtv, roi, [6000.0] * S, BATCHED_LEVELS))
    _hold_lanes("search chunk 0", outs["search"][0], sequential(
        raw, gtb, gtv, search, bw))
    for c, out in enumerate(outs["search"]):
        rungs = out["anchor_q"].tolist()
        print(f"[batched] search chunk {c}: anchor qualities by stream "
              f"{[[q for q in r if q] for r in rungs]}")
    picked = {q for r in outs["search"][0]["anchor_q"].tolist() for q in r
              if q}
    if len(picked) < 2:
        raise AssertionError(f"[batched] search picked one rung: {picked}")
    # the fused search against the per-anchor oracle, two streams
    for s in range(2):
        fused = outs["search"][0]
        oracle = RT.roundtrip_oracle(raw[s], gtb[s], gtv[s], params,
                                     cfg=search, bw_kbps=bw[s], **kw)
        for k in ("types", "anchor_q", "anchor_bits", "video_bits"):
            if not torch.equal(fused[k][s], oracle[k]):
                raise AssertionError(f"[batched] search stream {s}: {k} "
                                     "differs from roundtrip_oracle")
        same = [k for k in oracle if torch.equal(fused[k][s], oracle[k])]
        print(f"[batched] search stream {s} == roundtrip_oracle: rungs, "
              f"anchor_q and anchor_bits bit for bit ({len(same)} of "
              f"{len(oracle)} keys bit for bit)")

    for tag in runs:
        n = len(ms[tag])
        per = {k: v / n for k, v in sorted(launches[tag].items())}
        steady = statistics.median(ms[tag][1:])
        print(f"[batched] {tag}: {n} chunks of {S}x{T}x{H_HD}x{W_HD}: "
              f"first {ms[tag][0]:.1f} ms, median of the rest {steady:.1f} ms "
              f"(range {min(ms[tag][1:]):.1f}-{max(ms[tag][1:]):.1f}), "
              f"{S * T / steady * 1e3:.1f} frames/s against the "
              f"{FLOOR_FPS:.0f} frames/s floor; launches a chunk {per}, "
              f"{sum(per.values()):.0f} in all; peak device memory "
              f"{peak[tag] / 2**30:.2f} GiB")
    return {f"batched_{tag}": dict(n) for tag, n in launches.items()}


def phase_profile_batched(params, det_cfg) -> None:
    """One batched chunk of the nine streams (roundtrip_batched at rung 2)
    under torch.profiler, after two unprofiled chunks, in a process of its
    own (``--profile batched``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import roundtrip as RT
    _, chunks = _batched_chunks()
    cfg = RT.RoundtripConfig(level=LEVEL, det_cfg=det_cfg)
    kw = dict(tr1=TR1, tr2=TR2, bw_kbps=6000.0, queue_delay=0.0, cfg=cfg)
    warm = []
    for raw, gtb, gtv in chunks[:2]:
        t0 = time.perf_counter()
        RT.roundtrip_batched(raw, gtb, gtv, params, **kw)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] batched: alone in a process, unprofiled chunks "
          f"{', '.join(f'{v:.1f}' for v in warm)} ms")
    raw, gtb, gtv = chunks[2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        RT.roundtrip_batched(raw, gtb, gtv, params, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _print_profile(f"batched: one chunk {BATCHED_STREAMS}x{T}x{H_HD}x{W_HD}",
                   prof, wall)


# [sharded]: the nine streams split over a mesh of devices.  A logical mesh
# names the card several times: each shard runs the batched body on its
# slice of the streams, as it would on a card of its own
SHARDED_TIMED = (1, 2, 1)       # chunk 0 is the warm-up (and the parity run)
# the runtime's aggregate detector capacity: enough that no shard defers at
# nine 720p streams on 2 or 4 shards (per-shard admission would otherwise
# decide differently on the two meshes)
SHARDED_RUNTIME_FPS = 2160.0


def _sharded_meshes() -> list:
    """(tag, mesh, rules): the card itself, logical meshes of 3, 4 and
    (2, 2) shards on it, and a mesh over the cards when there are several."""
    import torch
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import (SINGLE_POD_RULES,
                                                  SINGLE_POD_RULES_DP)
    card = torch.device("cuda", 0)
    meshes = [
        ("1", make_mesh((1,), ("data",)), SINGLE_POD_RULES),
        ("3 logical", make_mesh((3,), ("data",), devices=[card] * 3),
         SINGLE_POD_RULES),
        ("4 logical", make_mesh((4,), ("data",), devices=[card] * 4),
         SINGLE_POD_RULES),
        ("2x2 logical", make_mesh((2, 2), ("data", "model"),
                                  devices=[card] * 4), SINGLE_POD_RULES_DP)]
    n = torch.cuda.device_count()
    if n > 1:
        k = min(n, 4)
        meshes.append((f"{k} cards", make_mesh((k,), ("data",)),
                       SINGLE_POD_RULES))
    else:
        print("[sharded] one CUDA device: no multi-card run was possible; "
              "the meshes of 3, 4 and 2x2 shards name the card several "
              "times (logical meshes)")
    return meshes


def _hold_bits(tag: str, out, ref) -> None:
    """Every output of a sharded call bit for bit its batched form's."""
    import dataclasses
    import torch
    if not isinstance(ref, dict):
        out, ref = ({f.name: getattr(x, f.name)
                     for f in dataclasses.fields(x)} for x in (out, ref))
    if set(out) != set(ref):
        raise AssertionError(f"[sharded] {tag}: keys differ")
    for k in ref:
        if out[k].shape != ref[k].shape or not torch.equal(out[k], ref[k]):
            diff = (out[k].double() - ref[k].double()).abs().max().item() \
                if out[k].shape == ref[k].shape else "shapes differ"
            raise AssertionError(f"[sharded] {tag}: {k} differs from the "
                                 f"batched form's ({diff})")


def phase_sharded(params, det_cfg) -> dict:
    """[sharded]: nine 720p streams of paper_stream_mix(9), one chunk, on
    each mesh of ``_sharded_meshes``: shard_roundtrip at rung 2, at
    BATCHED_LEVELS and with the budget search, shard_encode, shard_streams
    on that encode's output, and (3 shards) the padded canvas with the
    [roi] gate; each held bit for bit against the unsharded batched form
    and launching each kernel n_shards times as often.  Then the rung-2
    chunk timed against roundtrip_batched in turns, and the runtime's mesh
    mode.  Returns the launches of the sharded calls."""
    import collections
    import dataclasses
    import torch
    from repro_torch.codec.video_codec import (VideoCodecConfig,
                                               encode_chunk_batched)
    from repro_torch.core import roundtrip as RT
    from repro_torch.core.hybrid_decoder import decode_execute_batched
    from repro_torch.core.roi import RoiConfig
    from repro_torch.distributed.stream_sharding import (shard_encode,
                                                         shard_roundtrip,
                                                         shard_streams,
                                                         stream_shard_count)
    from repro_torch.kernels import build
    mix, chunks = _batched_chunks()
    S = len(mix)
    main = RT.RoundtripConfig(level=LEVEL, det_cfg=det_cfg)
    roi = dataclasses.replace(main, codec=VideoCodecConfig(**ROI_CODEC),
                              roi=RoiConfig(**ROI))
    search = dataclasses.replace(main, anchor_search=True)
    kw = dict(tr1=TR1, tr2=TR2, queue_delay=0.0)
    raw, gtb, gtv = chunks[0]
    canvas = RT.full_lr_canvas(H_HD, W_HD)
    lr = RT._downscale(raw, LEVEL)

    def counted(fn):
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(build.LAUNCHES)

    # the unsharded batched forms on chunk 0, and their launches
    base = {"roundtrip": counted(lambda: RT.roundtrip_batched(
        raw, gtb, gtv, params, cfg=main, bw_kbps=6000.0, **kw))}
    bw = _batched_bandwidths(raw, base["roundtrip"][0])
    types = base["roundtrip"][0]["types"]
    anchors = torch.where((types == 1)[..., None, None], raw, 0.0)
    total_bits = base["roundtrip"][0]["total_bits"]
    lr_pad = RT._downscale_pad(raw, BATCHED_LEVELS, canvas)
    ext, qual = RT.ladder_batch_arrays(BATCHED_LEVELS, H_HD, W_HD)
    base["ladder"] = counted(lambda: RT.roundtrip_ladder_batched(
        raw, gtb, gtv, params, levels=BATCHED_LEVELS, cfg=main,
        bw_kbps=6000.0, **kw))
    base["search"] = counted(lambda: RT.roundtrip_batched(
        raw, gtb, gtv, params, cfg=search, bw_kbps=bw, **kw))
    base["encode"] = counted(lambda: encode_chunk_batched(
        lr, main.codec_for()))
    exe = dict(bw_kbps=6000.0, queue_delay=0.0, total_bits=total_bits)
    base["streams"] = counted(lambda: decode_execute_batched(
        base["encode"][0], types, anchors, gtb, gtv, params, det_cfg, **exe))
    base["padded_roi"] = counted(lambda: RT.roundtrip_padded_batched(
        raw, lr_pad, ext, qual, gtb, gtv, params, cfg=roi, bw_kbps=6000.0,
        **kw))
    print(f"[sharded] batched forms' launches a chunk of {S} streams: "
          + "; ".join(f"{f} {sum(n.values())}" for f, (_, n) in base.items()))

    total = collections.Counter()
    for tag, mesh, rules in _sharded_meshes():
        n = stream_shard_count(mesh, rules)
        enc_out = {}
        forms = {
            "roundtrip": lambda: shard_roundtrip(mesh, rules, cfg=main)(
                raw, gtb, gtv, params, bw_kbps=6000.0, **kw),
            "ladder": lambda: shard_roundtrip(mesh, rules, cfg=main)(
                raw, gtb, gtv, params, bw_kbps=6000.0,
                levels=BATCHED_LEVELS, **kw),
            "search": lambda: shard_roundtrip(mesh, rules, cfg=search)(
                raw, gtb, gtv, params, bw_kbps=bw, **kw),
            "encode": lambda: enc_out.setdefault("enc", shard_encode(
                mesh, rules, cfg=main.codec_for())(lr)),
            "streams": lambda: shard_streams(mesh, rules, det_cfg=det_cfg)(
                enc_out["enc"], types, anchors, gtb, gtv, params, **exe)}
        if tag.startswith("3"):
            forms["padded_roi"] = lambda: shard_roundtrip(
                mesh, rules, cfg=roi)(raw, gtb, gtv, params, bw_kbps=6000.0,
                                      levels=BATCHED_LEVELS, canvas=canvas,
                                      **kw)
        per_form = {}
        for form, fn in forms.items():
            out, got = counted(fn)
            _hold_bits(f"mesh {tag} {form}", out, base[form][0])
            want = {k: n * v for k, v in base[form][1].items()}
            if got != want:
                raise AssertionError(f"[sharded] mesh {tag} {form}: launches "
                                     f"{got}, expected {n} x the batched "
                                     f"form's {base[form][1]}")
            total.update(got)
            per_form[form] = sum(got.values())
        print(f"[sharded] mesh {tag} ({n} shards over "
              f"{len(mesh.distinct_devices())} device(s)): "
              f"{', '.join(forms)} bit for bit the batched forms; launches "
              f"a chunk {per_form} = {n} x the batched forms'")

        # rung 2, the batched form and the sharded one in turns
        run = shard_roundtrip(mesh, rules, cfg=main)
        sides = {
            "batched": lambda r, b, v: RT.roundtrip_batched(
                r, b, v, params, cfg=main, bw_kbps=6000.0, **kw),
            "sharded": lambda r, b, v: run(r, b, v, params, bw_kbps=6000.0,
                                           **kw)}
        if tag == "1":
            # the sharded body is the masked mixed-ladder one: unsharded,
            # at one rung, it shows what the masks cost
            sides["ladder body"] = lambda r, b, v: \
                RT.roundtrip_ladder_batched(r, b, v, params,
                                            levels=(LEVEL,) * S, cfg=main,
                                            bw_kbps=6000.0, **kw)
        ms = {side: [] for side in sides}
        peak = dict.fromkeys(sides, 0)
        for c in SHARDED_TIMED:
            for side, fn in sides.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launches()
                t0 = time.perf_counter()
                fn(*chunks[c])
                torch.cuda.synchronize()
                ms[side].append((time.perf_counter() - t0) * 1e3)
                peak[side] = max(peak[side],
                                 torch.cuda.max_memory_allocated())
                if side == "sharded":
                    total.update(build.LAUNCHES)
        print(f"[sharded] mesh {tag} rung 2, in turns: " + "; ".join(
            f"{side} median {statistics.median(v):.1f} ms a chunk "
            f"({', '.join(f'{x:.1f}' for x in v)}), "
            f"{S * T / statistics.median(v) * 1e3:.1f} frames/s, peak "
            f"{peak[side] / 2**30:.2f} GiB" for side, v in ms.items()))
    _sharded_runtime(params, det_cfg)
    return dict(total)


def _sharded_runtime(params, det_cfg) -> None:
    """EdgeRuntime in mesh mode on four logical shards serves nine 720p
    streams for three batch-submit rounds, equal in detections and stats
    to the runtime with ServingConfig(n_shards=4) and no mesh; then shard
    3's group fails, ``remesh`` rebuilds a mesh of the survivors, and a
    runtime on it serves the same streams again: every stream served, the
    detections bit for bit the no-fault ones."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.hybrid_encoder import encode_hybrid
    from repro_torch.distributed.sharding import SINGLE_POD_RULES
    from repro_torch.serving.elastic import ElasticPool, remesh
    from repro_torch.serving.runtime import EdgeRuntime
    from repro_torch.serving.scheduler import ServingConfig
    from repro_torch.sim.video_source import generate_chunk
    card = torch.device("cuda", 0)
    mix = _streams(BATCHED_STREAMS)
    rounds = [[(encode_hybrid(generate_chunk(sc, t * T, T)[0], 6000.0, TR1,
                              TR2), None, None) for sc in mix]
              for t in range(3)]
    cfg = ServingConfig(n_streams=len(mix),
                        gpu_capacity_fps=SHARDED_RUNTIME_FPS)

    def serve(rt):
        polls, ms = [], []
        with rt:
            for t, packets in enumerate(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                polls.append(_round(rt, packets, t))
                ms.append((time.perf_counter() - t0) * 1e3)
        stats = {c: s.as_dict() for c, s in rt.stats.items()}
        for c, s in rt.stats.items():
            if s.frames_in != s.frames_inferred + s.frames_reused \
                    + s.frames_skipped:
                raise AssertionError(f"[sharded] runtime stream {c}: frames "
                                     f"unaccounted {s.as_dict()}")
        if rt.deferred:
            raise AssertionError(f"[sharded] runtime deferred {rt.deferred}")
        return polls, stats, ms

    def same(a, b) -> bool:
        return all(np.array_equal(x, y) for pa, pb in zip(a, b)
                   for ta, tb in zip(pa, pb) for x, y in zip(ta, tb))

    pool = ElasticPool(4)
    mesh4 = remesh(pool, devices=[card] * 4)
    meshed = serve(EdgeRuntime(cfg, params, det_cfg, mesh=mesh4,
                               rules=SINGLE_POD_RULES))
    logical = serve(EdgeRuntime(dataclasses.replace(cfg, n_shards=4),
                                params, det_cfg))
    if not same(meshed[0], logical[0]) or meshed[1] != logical[1]:
        raise AssertionError("[sharded] runtime: mesh mode differs from "
                             "the logical shards")
    pool.fail(3)
    mesh2 = remesh(pool, devices=[card] * 4)
    rebuilt = serve(EdgeRuntime(cfg, params, det_cfg, mesh=mesh2,
                                rules=SINGLE_POD_RULES))
    if not same(rebuilt[0], meshed[0]):
        raise AssertionError("[sharded] runtime after remesh: detections "
                             "differ from the no-fault ones")
    runs = [("mesh mode, 4 logical shards", meshed),
            ("logical shards, no mesh", logical),
            (f"remeshed on {mesh2.size} shards", rebuilt)]
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        # the same on a mesh over the cards, a detector on each card
        k = min(n_dev, 4)
        cards = remesh(ElasticPool(k), devices=[torch.device("cuda", i)
                                                for i in range(k)])
        on_cards = serve(EdgeRuntime(cfg, params, det_cfg, mesh=cards,
                                     rules=SINGLE_POD_RULES))
        if not same(on_cards[0], meshed[0]):
            raise AssertionError("[sharded] runtime on the cards differs "
                                 "from the logical mesh")
        runs.append((f"mesh over {cards.size} cards", on_cards))
    frames = len(mix) * T
    for tag, (_, _, ms) in runs:
        print(f"[sharded] runtime {tag}: rounds "
              f"{', '.join(f'{v:.1f}' for v in ms)} ms "
              f"({frames / statistics.median(ms) * 1e3:.1f} frames/s at the "
              f"median)")
    print(f"[sharded] runtime: mesh mode == logical shards in detections and "
          f"stats over 3 rounds of {len(mix)} streams; shard 3 failed, "
          f"remesh -> {dict(mesh2.shape)}, every stream served, detections "
          f"bit for bit the no-fault ones")


def check_threaded_launch() -> None:
    """Each kernel form of the round trip and the LM, called from a worker
    thread (whose current CUDA device is the default one) on tensors of
    the last card, bit for bit the same call from the main thread: the
    launch runs under the tensors' device, whatever the thread's."""
    import concurrent.futures
    import torch
    from repro_torch.codec import blockdct as B
    from repro_torch.kernels.blockdct.ops import (forward_quant_raster,
                                                  inverse_raster)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.motion_sad.ops import motion_sad
    from repro_torch.kernels.qtransfer.ops import qtransfer
    from repro_torch.kernels.roi_gather.ops import roi_gather
    from repro_torch.kernels.seq_sum.ops import seq_sum
    n_dev = torch.cuda.device_count()
    dev = torch.device("cuda", n_dev - 1)
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.rand((3, 64, 96), generator=g, device=dev) * 255
    dmat, qtab = B.dct_matrix(8, dev), B.quant_table(50.0, dev)
    q, _ = forward_quant_raster(frames, dmat, qtab)
    mv = torch.randint(-8, 9, (3, 4, 6, 2), generator=g, device=dev,
                       dtype=torch.int32)
    planes = torch.rand((3, 112, 144), generator=g, device=dev)
    ry = torch.randint(0, 2, (3, 2), generator=g, device=dev,
                       dtype=torch.int32)
    qkv = [torch.randn((1, 128, 4, 64), generator=g, device=dev)
           .to(torch.bfloat16) for _ in range(3)]
    calls = {
        "motion_sad": lambda: motion_sad(frames[1:], frames[:-1], 8),
        "motion_sad_diamond_bf16": lambda: motion_sad(
            frames[1:], frames[:-1], 8, dtype=torch.bfloat16,
            search="diamond"),
        "blockdct_forward": lambda: forward_quant_raster(frames, dmat, qtab),
        "blockdct_inverse": lambda: inverse_raster(q, dmat, qtab, 64, 96),
        "qtransfer": lambda: qtransfer(frames, mv, frames),
        "roi_gather": lambda: roi_gather(planes, ry, ry, region_px=32,
                                         halo=8),
        "seq_sum": lambda: seq_sum(frames),
        "flash_attention": lambda: flash_attention(*qkv, causal=True)}
    mine = {k: f() for k, f in calls.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        current = pool.submit(torch.cuda.current_device).result()
        theirs = {k: pool.submit(f).result() for k, f in calls.items()}
    torch.cuda.synchronize(dev)
    for k in calls:
        a = mine[k] if isinstance(mine[k], tuple) else (mine[k],)
        b = theirs[k] if isinstance(theirs[k], tuple) else (theirs[k],)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"[threads] {k}: the worker thread's call "
                                 "differs from the main thread's")
    print(f"[threads] {len(calls)} kernel forms called from a worker thread "
          f"(current device cuda:{current}) on tensors of {dev}: bit for bit "
          f"the main thread's calls; "
          + ("the cross-card case (tensors on another card than the "
             "thread's current device) stays unverified on this one-card "
             "machine" if n_dev == 1 else "across cards"))


# [control]: the bi-level control plane (SAC controller, nine A2C agents)
# choosing the nine 720p streams' bandwidths and thresholds chunk by chunk,
# through BiLevelTrainer.create / run_chunk / run_chunk_loop / flush
CONTROL_CHUNKS = 8              # the detector backend, each trainer
CONTROL_ROI_CHUNKS = 3
CONTROL_ANALYTIC_CHUNKS = 140   # the SAC update engages at the paper's 128
CONTROL_LOW_BATCH, CONTROL_MINIBATCH = 4, 6     # both updates in 8 chunks
# one round-trip call a chunk for the nine streams (one frame shape): the
# launches of one stream, the encode's blockdct forwards at a table a frame
# (each stream's rung); with the ROI gate and the budget search as well
CONTROL_LAUNCHES = MAIN_LAUNCHES
CONTROL_ROI_LAUNCHES = dict(SEARCH_LAUNCHES, roi_gather=1)
# where the card does not give the stacked and the loop trainer the same
# bits (a reduction's order may follow its output count), each must stay
# within: the actions, proportions and states written to replay (the CPU
# port drifts from the reference by at most 2.1e-5 over 8 chunks); the
# chunk metrics and rewards, relative, on chunks whose frame types agree
# (and the run fails if a type differs: that needs a feature within ~1e-6
# of its threshold); the parameters, by 3 lr a step that ran (an Adam step
# moves an element by about lr at most, so two runs whose near-zero
# gradients round to other signs part by up to 2 lr a step)
CONTROL_ACTION_TOL = 1e-4
CONTROL_METRIC_TOL = 1e-4


def _control_cfg(**kw):
    """The port's biswift_edge configuration of nine 720p streams, its
    streams the [batched] ones (paper_stream_mix scaled to 720 px)."""
    import dataclasses
    from repro_torch.configs import biswift_edge
    _, env, _ = biswift_edge.build(BATCHED_STREAMS, H_HD, W_HD)
    return dataclasses.replace(env, streams=tuple(_streams(BATCHED_STREAMS)),
                               **kw)


def _control_trainer(cfg, det, low_batch: int, minibatch: int):
    import dataclasses
    from repro_torch.core.bilevel import BiLevelTrainer
    tr = BiLevelTrainer.create(cfg, seed=0, detector=det,
                               low_batch=low_batch)
    tr.controller.cfg = dataclasses.replace(tr.controller.cfg,
                                            minibatch=minibatch)
    return tr


class _ChunkClock:
    """Splits a chunk's wall time at the env step: the observation and
    ``bilevel_step`` before it (the control step), ``env.step`` itself,
    and what follows (the replay writes and the next chunk's render and
    features); and times each ``bilevel_step`` call on its own, host time
    to return and CUDA events, with its update flags."""

    def __init__(self, trainer):
        import torch
        from repro_torch.core import bilevel as BL
        self.torch, self.BL = torch, BL
        self.step_fn = BL.bilevel_step
        self.env_step = trainer.env.step
        trainer.env.step = self._env_step
        self.steps = []

    def _env_step(self, *a, **k):
        self.torch.cuda.synchronize()
        self.t_env = time.perf_counter()
        out = self.env_step(*a, **k)
        self.torch.cuda.synchronize()
        self.env_ms = (time.perf_counter() - self.t_env) * 1e3
        return out

    def _bilevel_step(self, *a, **k):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        out = self.step_fn(*a, **k)
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        self.steps.append({"host_ms": host, "ms": start.elapsed_time(end),
                           "do_low": k["do_low"], "do_high": k["do_high"]})
        return out

    def chunk(self, run) -> dict:
        """One chunk of ``run`` (``run_chunk`` or ``run_chunk_loop``):
        its output and times, launches by kernel and peak memory."""
        from repro_torch.kernels import build
        torch = self.torch
        self.BL.bilevel_step = self._bilevel_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            self.BL.bilevel_step = self.step_fn
        wall = (time.perf_counter() - t0) * 1e3
        control = (self.t_env - t0) * 1e3
        return {"out": out, "wall_ms": wall, "env_ms": self.env_ms,
                "control_ms": control,
                "after_ms": wall - control - self.env_ms,
                "launches": dict(build.LAUNCHES),
                "peak": torch.cuda.max_memory_allocated()}


def _rungs(results) -> list:
    from repro_torch.codec.rate_model import (ladder_for_bandwidth,
                                              video_bandwidth_share)
    return [ladder_for_bandwidth(video_bandwidth_share(x["bw_kbps"]))
            for x in results]


def _print_chunk(tag: str, c: int, r: dict) -> None:
    metrics, results = r["out"][0], r["out"][1]
    n = sum(len(x["types"]) for x in results)
    mix = [sum(int((x["types"] == k).sum()) for x in results)
           for k in (1, 2, 3)]
    print(f"[control] {tag} chunk {c}: observe + bilevel_step "
          f"{r['control_ms']:.1f} ms, env.step {r['env_ms']:.1f} ms, after "
          f"{r['after_ms']:.1f} ms, wall {r['wall_ms']:.1f} ms "
          f"({n / r['wall_ms'] * 1e3:.1f} frames/s against the "
          f"{FLOOR_FPS:.0f} floor); launches {r['launches']}; peak "
          f"{r['peak'] / 2**30:.2f} GiB; pipelines {mix}, rungs "
          f"{_rungs(results)}, mean_acc {metrics['mean_acc']:.4f}")


def _max_diff(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def _hold_trainers(stacked, loop, chunks_s, chunks_l) -> None:
    """The stacked trainer (run_chunk x n + flush) against the loop
    trainer (run_chunk_loop x n): bit for bit, or within the CONTROL_*
    tolerances, each largest difference printed."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_leaves
    for c, (a, b) in enumerate(zip(chunks_s, chunks_l)):
        for ra, rb in zip(a["out"][1], b["out"][1]):
            if not np.array_equal(ra["types"], rb["types"]):
                raise AssertionError(f"[control] chunk {c} stream "
                                     f"{ra['stream']}: frame types differ")
    metrics = [(a["out"][0], b["out"][0]) for a, b in zip(chunks_s, chunks_l)]
    diffs = {
        "metrics": max(abs(x[k] - y[k]) / max(abs(y[k]), 1.0)
                       for x, y in metrics for k in y),
        "replay states": max(_max_diff(getattr(stacked.low_buffer, k),
                                       getattr(loop.low_buffer, k))
                             for k in ("s", "s2")),
        "replay actions": _max_diff(stacked.low_buffer.a, loop.low_buffer.a),
        "replay rewards": _max_diff(stacked.low_buffer.r, loop.low_buffer.r),
        "controller replay": max(
            _max_diff(getattr(stacked.controller.buffer, k),
                      getattr(loop.controller.buffer, k))
            for k in ("s", "a", "r", "s2")),
        "proportions": _max_diff(stacked.controller._current,
                                 loop.controller._current),
    }
    nets = {"low actor": ("actor", stacked.low_cfg.lr_actor, "opt_a"),
            "low critic": ("critic", stacked.low_cfg.lr_critic, "opt_c")}
    params = {name: (stacked.low_stack[k], loop.low_stack[k], lr,
                     int(loop.low_stack[opt]["step"].max()))
              for name, (k, lr, opt) in nets.items()}
    scfg = stacked.controller.cfg
    for net, lr in (("actor", scfg.lr_policy), ("value", scfg.lr_value),
                    ("q1", scfg.lr_q), ("q2", scfg.lr_q)):
        params[f"SAC {net}"] = (stacked.controller.agent[net],
                                loop.controller.agent[net], lr,
                                loop.controller.updates)
    for name, (a, b, lr, n) in params.items():
        d = max(_max_diff(x.cpu(), y.cpu())
                for x, y in zip(tree_leaves(a), tree_leaves(b)))
        diffs[f"{name} params"] = d
        if d > 3 * lr * n:
            raise AssertionError(f"[control] {name} params differ by {d} > "
                                 f"3 lr x {n} steps")
    every = zip(tree_leaves(stacked.low_stack)
                + tree_leaves(stacked.controller.agent),
                tree_leaves(loop.low_stack)
                + tree_leaves(loop.controller.agent))
    if all(v == 0.0 for v in diffs.values()) \
            and all(torch.equal(x, y) for x, y in every):
        print(f"[control] stacked run_chunk x {len(chunks_s)} + flush == "
              f"run_chunk_loop x {len(chunks_l)} bit for bit: metrics, "
              "replay contents, proportions, thresholds and every parameter "
              "and optimiser moment")
        return
    print("[control] stacked vs loop: not bit for bit on this card; largest "
          f"differences { {k: float(f'{v:.3g}') for k, v in diffs.items()} }")
    for k in ("replay states", "replay actions", "proportions",
              "controller replay"):
        if diffs[k] > CONTROL_ACTION_TOL:
            raise AssertionError(f"[control] {k} differ by {diffs[k]}")
    for k in ("metrics", "replay rewards"):
        if diffs[k] > CONTROL_METRIC_TOL:
            raise AssertionError(f"[control] {k} differ by {diffs[k]}")


def phase_control(params, det_cfg) -> dict:
    """[control]: (1) detector backend, two trainers from one seed, one
    through run_chunk x 8 + flush and one through run_chunk_loop x 8, in
    turns chunk by chunk, held against each other; (2) three chunks with
    the ROI gate and the budget search; (3) the analytic backend at the
    paper's hyper-parameters (low batch 32, SAC minibatch 128), 140
    chunks, the bilevel_step's times in three parts.  Returns each run's
    launch counts."""
    import collections
    import statistics as st
    from repro_torch.core.roi import RoiConfig
    det = (params, det_cfg)
    launches = {}

    # (1) the detector backend, stacked and loop in turns
    cfg = _control_cfg(accuracy_backend="detector")
    stacked = _control_trainer(cfg, det, CONTROL_LOW_BATCH, CONTROL_MINIBATCH)
    loop = _control_trainer(cfg, det, CONTROL_LOW_BATCH, CONTROL_MINIBATCH)
    clocks = {"stacked": _ChunkClock(stacked), "loop": _ChunkClock(loop)}
    runs = {"stacked": stacked.run_chunk, "loop": loop.run_chunk_loop}
    chunks = {tag: [] for tag in runs}
    for c in range(CONTROL_CHUNKS):
        for tag, run in runs.items():
            r = clocks[tag].chunk(run)
            _expect_launches(f"[control] detector {tag} chunk {c}",
                             CONTROL_LAUNCHES)
            chunks[tag].append(r)
            _print_chunk(f"detector {tag}", c, r)
    stacked.flush()
    for tag, tr in (("stacked", stacked), ("loop", loop)):
        print(f"[control] detector {tag}: A2C updates "
              f"{int(tr.low_stack['opt_a']['step'].max())} a stream, SAC "
              f"updates {tr.controller.updates}; last chunk's logs "
              f"{sorted(chunks[tag][-1]['out'][3])}")
        if tr.controller.updates < 1 \
                or int(tr.low_stack["opt_a"]["step"].min()) < 1:
            raise AssertionError(f"[control] {tag}: an update never ran")
        for r in chunks[tag]:
            for x in r["out"][1]:
                if not all(math.isfinite(x[k]) for k in
                           ("accuracy", "latency", "bits", "reward")) \
                        or x["types"][0] != 1 or len(x["types"]) != T:
                    raise AssertionError(f"[control] {tag}: bad result {x}")
    _hold_trainers(stacked, loop, chunks["stacked"], chunks["loop"])
    for tag in runs:
        rest = chunks[tag][1:]
        wall = st.median(r["wall_ms"] for r in rest)
        per = collections.Counter()
        for r in chunks[tag]:
            per.update(r["launches"])
        launches[f"control_{tag}"] = dict(per)
        steps = clocks[tag].steps[1:]
        step = "" if not steps else (
            f"; bilevel_step host {st.median(s['host_ms'] for s in steps):.2f}"
            f" ms, events {st.median(s['ms'] for s in steps):.2f} ms")
        print(f"[control] detector {tag}: {len(chunks[tag])} chunks of "
              f"{BATCHED_STREAMS}x{T}x{H_HD}x{W_HD}, median of the rest: "
              f"observe + bilevel_step "
              f"{st.median(r['control_ms'] for r in rest):.1f} ms, env.step "
              f"{st.median(r['env_ms'] for r in rest):.1f} ms, after "
              f"{st.median(r['after_ms'] for r in rest):.1f} ms, wall "
              f"{wall:.1f} ms ({BATCHED_STREAMS * T / wall * 1e3:.1f} "
              f"frames/s against the {FLOOR_FPS:.0f} floor); peak "
              f"{max(r['peak'] for r in chunks[tag]) / 2**30:.2f} GiB{step}")
    del stacked, loop, clocks, chunks, runs

    # (2) the ROI gate and the budget search
    cfg = _control_cfg(accuracy_backend="detector", roi=RoiConfig(**ROI),
                       anchor_search=True)
    tr = _control_trainer(cfg, det, CONTROL_LOW_BATCH, CONTROL_MINIBATCH)
    clock = _ChunkClock(tr)
    per = collections.Counter()
    for c in range(CONTROL_ROI_CHUNKS):
        r = clock.chunk(tr.run_chunk)
        _expect_launches(f"[control] roi+search chunk {c}",
                         CONTROL_ROI_LAUNCHES)
        per.update(r["launches"])
        _print_chunk("roi+search", c, r)
    tr.flush()
    launches["control_roi_search"] = dict(per)
    print(f"[control] roi+search: launches a chunk "
          f"{ {k: v / CONTROL_ROI_CHUNKS for k, v in sorted(per.items())} }:"
          f" roi_gather {per['roi_gather'] // CONTROL_ROI_CHUNKS}, "
          f"blockdct_forward {per['blockdct_forward'] // CONTROL_ROI_CHUNKS} "
          "at a table a frame (the mixed-rung encode, the search's rungs)")
    del tr, clock

    # (3) the analytic backend at the paper's hyper-parameters
    tr = _control_trainer(_control_cfg(), None, 32, 128)
    clock = _ChunkClock(tr)
    walls = []
    for c in range(CONTROL_ANALYTIC_CHUNKS):
        r = clock.chunk(tr.run_chunk)
        if r["launches"]:
            raise AssertionError(f"[control] analytic chunk {c} launched "
                                 f"{r['launches']}")
        walls.append(r)
    tr.flush()
    parts = {"acting alone": (False, False),
             "with the A2C update": (True, False),
             "with both updates": (True, True)}
    for name, flags in parts.items():
        idx = [i for i, s in enumerate(clock.steps)
               if (s["do_low"], s["do_high"]) == flags][1:]
        if not idx:
            raise AssertionError(f"[control] analytic: no step {name}")
        sel = [clock.steps[i] for i in idx]
        print(f"[control] analytic bilevel_step {name}: {len(sel)} steps, "
              f"median host {st.median(s['host_ms'] for s in sel):.2f} ms, "
              f"events {st.median(s['ms'] for s in sel):.2f} ms; chunk wall "
              f"{st.median(walls[i]['wall_ms'] for i in idx):.1f} ms, "
              f"env.step {st.median(walls[i]['env_ms'] for i in idx):.1f} "
              f"ms, after {st.median(walls[i]['after_ms'] for i in idx):.1f}"
              " ms")
    print(f"[control] analytic: {CONTROL_ANALYTIC_CHUNKS} chunks, SAC updates "
          f"{tr.controller.updates}, A2C updates "
          f"{int(tr.low_stack['opt_a']['step'].max())} a stream; mean_acc "
          f"first {walls[0]['out'][0]['mean_acc']:.4f}, last "
          f"{walls[-1]['out'][0]['mean_acc']:.4f}; peak "
          f"{max(r['peak'] for r in walls) / 2**30:.2f} GiB; the steps' "
          "launches: [profile] control")
    return launches


def _d2h_bytes(prof, path) -> tuple:
    """(device-to-host bytes, copies) of a profiled window, from the
    memcpy events of its exported trace; (None, n) where the trace gives
    no byte counts."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    copies = [e for e in events if "DtoH" in e.get("name", "")
              and e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    if not copies or any(s is None for s in sizes):
        return None, len(copies)
    return sum(sizes), len(copies)


def phase_profile_control(params, det_cfg) -> None:
    """``--profile control``: (1) the analytic backend at the paper's
    hyper-parameters, one bilevel_step profiled acting alone, one with the
    A2C update and one with both (by chunk 129): device ops (launches and
    copies) and host ops; (2) the detector backend, one chunk with both
    updates on under torch.profiler after 7 unprofiled: busy share, top
    device rows, host operators and device-to-host bytes."""
    import pathlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bilevel as BL
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out_dir = pathlib.Path(ROOT) / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)

    tr = _control_trainer(_control_cfg(), None, 32, 128)
    step_fn = BL.bilevel_step
    want = {(False, False): "acting alone", (True, False):
            "with the A2C update", (True, True): "with both updates"}
    seen = {(False, False)}        # chunk 0's step: the first act

    def profiled(*a, **k):
        flags = (k["do_low"], k["do_high"])
        if flags in seen:
            return step_fn(*a, **k)
        seen.add(flags)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            out = step_fn(*a, **k)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        dev = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e for e in rows
                if e.device_type == torch.autograd.DeviceType.CPU]
        print(f"[profile] control bilevel_step {want[flags]} (chunk "
              f"{tr.env.t}): {sum(e.count for e in dev)} device ops, "
              f"{sum(e.self_device_time_total for e in dev) / 1e3:.3f} ms "
              f"busy; {sum(e.count for e in host)} host ops, "
              f"{sum(e.self_cpu_time_total for e in host) / 1e3:.2f} ms")
        return out

    BL.bilevel_step = profiled
    try:
        tr.run_chunk()
        seen.discard((False, False))
        while len(seen) < len(want):
            tr.run_chunk()
    finally:
        BL.bilevel_step = step_fn
    del tr

    tr = _control_trainer(_control_cfg(accuracy_backend="detector"),
                          (params, det_cfg), CONTROL_LOW_BATCH,
                          CONTROL_MINIBATCH)
    warm = []
    for _ in range(CONTROL_CHUNKS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_chunk()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    if not (tr._pending["do_low"] and tr._pending["do_high"]):
        raise AssertionError("[profile] control: both updates must be due")
    print(f"[profile] control: alone in a process, unprofiled chunks "
          f"{', '.join(f'{v:.1f}' for v in warm)} ms")
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.run_chunk()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _print_profile(f"control: one detector chunk {BATCHED_STREAMS}x{T}x"
                   f"{H_HD}x{W_HD} with both updates", prof, wall)
    n_bytes, n = _d2h_bytes(prof, out_dir / "control_chunk.json")
    frames = BATCHED_STREAMS * T * H_HD * W_HD * F32
    print(f"[profile] control: device-to-host copies in the chunk: {n}, "
          + ("bytes not measured (the trace gives none)" if n_bytes is None
             else f"{n_bytes} bytes ({n_bytes / 1024:.1f} KiB); one chunk's "
             f"frames are {frames / 2**20:.0f} MiB"))


# [serving]: the serving plane (the hybrid encoder at the camera, the edge
# runtime's submit/flush/poll, the chaos soak, the serve launcher) at the
# paper's load: nine 720p cameras, 30-frame chunks
SERVE_ARGV = ["--streams", "9", "--height", str(H_HD), "--width", str(W_HD),
              "--chunk-frames", str(T), "--chunks", "3", "--controller",
              "sac"]
# the launches a stream-chunk of the serve loop: encode_hybrid's video
# encode (29 searches, 29 compensations, 30 transforms, 2 sums), its probe
# of the first anchor at five qualities and its anchors (one blockdct
# forward each) and the sums of the video, probe and anchor bits; the
# runtime's default path launches no kernel (type-2 frames are staged as
# upscaled LR, with no quality transfer, as in the reference)
SERVE_LAUNCHES = {"motion_sad": T - 1, "qtransfer": T - 1,
                  "blockdct_forward": T + 2, "seq_sum": 5}
# one batch-submit round with the ROI gate and the anchor search: a stream's
# rung bits take one blockdct forward and one seq_sum a rung (6 rungs), the
# round's one detector dispatch one roi_gather
ROI_SEARCH_LAUNCHES = {"blockdct_forward": 6 * BATCHED_STREAMS,
                       "seq_sum": 6 * BATCHED_STREAMS, "roi_gather": 1}
LEGACY_LAUNCHES = {"blockdct_inverse": 1, "qtransfer": 1}
SOAK = dict(n_streams=BATCHED_STREAMS, n_chunks=12, chunk_frames=T,
            height=H_HD, width=W_HD, mean_kbps=54000.0)
# the soak fields decided on the host, which the sync and batch-submit
# soaks must share
SOAK_FIELDS = ("accounting_ok", "delivered_fps", "infer_fps", "fps_norm",
               "infer_norm", "stream_stats", "recovery", "recovery_infer",
               "fault_log", "queue_leaks", "active_shards_final",
               "hedged_dispatches", "forecast_holds")


class _Split:
    """Exclusive time by name of wrapped functions, each call bracketed
    by device synchronisations (so that a call is charged the device work
    it queued); a wrapped call inside another counts only toward its own
    name."""

    def __init__(self):
        import collections
        self.ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._stack = []

    def wrap(self, name, fn):
        import torch

        def timed(*a, **k):
            torch.cuda.synchronize()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                self.ms[name] += dt - self._stack.pop()
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed


def _patched(*triples):
    """A context that sets each (object, attribute, value) for its
    length."""
    import contextlib
    from unittest import mock
    stack = contextlib.ExitStack()
    for obj, name, value in triples:
        stack.enter_context(mock.patch.object(obj, name, value))
    return stack


def _serve_run(argv=SERVE_ARGV) -> dict:
    """serve.main at the paper's load (by default with its quick-train),
    the split of each round and the launches of each stream-chunk."""
    import collections
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import serve as S
    from repro_torch.serving.runtime import EdgeRuntime
    from repro_torch.sim.env import MultiStreamEnv
    split = _Split()
    total = collections.Counter()
    state = {"chunks": 0, "rounds": [], "training": False}

    def chunk_boundary():
        if state["chunks"]:
            _expect_launches(f"[serving] serve stream-chunk "
                             f"{state['chunks'] - 1}", SERVE_LAUNCHES)
        total.update(build.LAUNCHES)
        build.reset_launches()

    encode = split.wrap("encode_hybrid", S.encode_hybrid)
    # the cameras' frames, apart from the quick-train's
    renders = {False: split.wrap("render", S.generate_chunk),
               True: split.wrap("render_train", S.generate_chunk)}
    train = split.wrap("quick_train", S.quick_train)

    def quick_train(*a, **k):
        state["training"] = True
        try:
            return train(*a, **k)
        finally:
            state["training"] = False

    def render(*a, **k):
        return renders[state["training"]](*a, **k)

    def encode_counted(*a, **k):
        chunk_boundary()
        state["chunks"] += 1
        return encode(*a, **k)

    observe = MultiStreamEnv.observe_high

    def observe_marked(self):
        state["rounds"].append(time.perf_counter())
        return observe(self)

    patches = _patched(
        (S, "encode_hybrid", encode_counted),
        (S, "quick_train", quick_train),
        (S, "generate_chunk", render),
        (S, "chunk_f1", split.wrap("nms_f1", S.chunk_f1)),
        (EdgeRuntime, "submit_chunk",
         split.wrap("submit_chunk", EdgeRuntime.submit_chunk)),
        (EdgeRuntime, "flush", split.wrap("flush", EdgeRuntime.flush)),
        (EdgeRuntime, "poll", split.wrap("poll", EdgeRuntime.poll)),
        (MultiStreamEnv, "observe_high",
         split.wrap("observe_high", observe_marked)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with patches:
        out = S.main(argv)
        torch.cuda.synchronize()
        end = time.perf_counter()
        chunk_boundary()
    n_chunks = state["chunks"]
    if n_chunks != 3 * BATCHED_STREAMS:
        raise AssertionError(f"[serving] serve encoded {n_chunks} chunks")
    if any(not math.isfinite(v) for v in out["f1"] + out["latency"]):
        raise AssertionError("[serving] serve: a non-finite F1 or latency")
    bounds = state["rounds"] + [end]
    rounds = [(b - a) * 1e3 for a, b in zip(bounds, bounds[1:])]
    return dict(out=out, split=split, rounds=rounds, launches=dict(total),
                peak=torch.cuda.max_memory_allocated())


def _serving_packets(streams, level=None):
    """One 720p chunk of each stream through ``encode_hybrid`` at 6,000
    kbps (the frames rendered on the card)."""
    from repro_torch.core.hybrid_encoder import encode_hybrid
    from repro_torch.sim.video_source import generate_chunk
    out = []
    for sc in streams:
        raw, gtb, gtv = generate_chunk(sc, 0, T)
        out.append((encode_hybrid(raw, 6000.0, TR1, TR2, level=level),
                    gtb, gtv))
    return out


def _round(rt, packets, t: int = 0) -> list:
    """One batch-submit round: every stream submitted, one flush, every
    ticket polled."""
    tks = [rt.submit_chunk(c, t, p) for c, (p, _, _) in enumerate(packets)]
    rt.flush()
    return [rt.poll(tk) for tk in tks]


def _soak_split(rt_cls):
    """Wrap the runtime's group dispatch and detector call with counters;
    returns (the counter, the patches)."""
    import collections
    n = collections.Counter()
    group, infer = rt_cls._dispatch_group, rt_cls._infer_batch_dev

    def counted_group(self, shard, tickets):
        n["groups"] += 1
        n["rows"] += sum(len(tk.reqs) for tk in tickets)
        return group(self, shard, tickets)

    def counted_infer(self, *a, **k):
        n["dispatches"] += 1
        return infer(self, *a, **k)

    return n, _patched((rt_cls, "_dispatch_group", counted_group),
                       (rt_cls, "_infer_batch_dev", counted_infer))


def phase_serving(params, det_cfg) -> tuple:
    """[serving]: (1) serve.main on nine 720p streams, three chunks, the
    SAC controller, its 150-step quick-train; (2) the chaos soak at the
    paper's load: loss-burst chunk-sequential and batch-submit, held equal
    in every host-decided field, then shard-chaos on two logical shards;
    (3) one batch-submit round with the ROI gate and the anchor search;
    (4) the legacy decode of one 720p packet against the fused one; (5)
    64x96 packets through the runtime on the card against the port's CPU
    path.  Returns the launches of the runs and (1)'s summary."""
    import collections
    import numpy as np
    import torch
    from repro_torch.core import hybrid_decoder as HD
    from repro_torch.core.roi import RoiConfig
    from repro_torch.kernels import build
    from repro_torch.serving import faults as FL
    from repro_torch.serving.runtime import EdgeRuntime
    from repro_torch.serving.scheduler import ServingConfig
    launches = collections.Counter()

    # (1) the launcher
    r = _serve_run()
    launches.update(r["launches"])
    out, split = r["out"], r["split"]
    frames = BATCHED_STREAMS * T
    print(f"[serving] serve: quick-train 150 steps "
          f"{split.ms['quick_train'] + split.ms['render_train']:.1f} ms "
          f"({split.ms['render_train']:.1f} of it rendering its chunks)")
    steady = statistics.median(r["rounds"][1:])
    print(f"[serving] serve: rounds of {BATCHED_STREAMS} streams x {T}x"
          f"{H_HD}x{W_HD}: {', '.join(f'{v:.1f}' for v in r['rounds'])} ms;"
          f" median of the later {steady:.1f} ms ({frames / steady * 1e3:.1f}"
          f" frames/s against the {FLOOR_FPS:.0f} floor); serve's own wall "
          f"{out['wall_s'] * 1e3:.1f} ms, {out['fps']:.1f} frames/s")
    n = 3 * BATCHED_STREAMS
    print("[serving] serve split a stream-chunk (ms, each call ending in a "
          "device sync): " + ", ".join(
              f"{k} {split.ms[k] / n:.2f}" for k in
              ("render", "encode_hybrid", "submit_chunk", "flush", "poll",
               "nms_f1")) + f"; observe_high {split.ms['observe_high'] / 3:.2f}"
          " a round")
    print(f"[serving] serve: launches a stream-chunk {SERVE_LAUNCHES} "
          f"(all {n} checked); over the run {r['launches']}")
    print(f"[serving] serve: mean F1 {statistics.mean(out['f1']):.4f}, mean "
          f"latency {statistics.mean(out['latency']) * 1e3:.1f} ms, peak "
          f"device memory {r['peak'] / 2**30:.2f} GiB")

    # (2) the chaos soak
    cfg = FL.SoakConfig(**SOAK)
    reports = {}
    for mode in ("sync", "batch_submit"):
        counts, patch = _soak_split(EdgeRuntime)
        build.reset_launches()
        with patch:
            reports[mode] = FL.run_soak(cfg, FL.preset_schedule(
                "loss-burst", n_chunks=cfg.n_chunks,
                n_streams=cfg.n_streams, seed=cfg.seed),
                batch_submit=mode == "batch_submit")
        launches.update(build.LAUNCHES)
        rep = reports[mode]
        if not rep["accounting_ok"] or rep["queue_leaks"]:
            raise AssertionError(f"[serving] soak loss-burst {mode}: "
                                 f"accounting {rep['accounting_ok']}, "
                                 f"leaks {rep['queue_leaks']}")
        print(f"[serving] soak loss-burst {mode}: {cfg.n_chunks} rounds in "
              f"{rep['wall_s'] * 1e3:.1f} ms "
              f"({rep['wall_s'] * 1e3 / cfg.n_chunks:.1f} ms a round, the "
              f"encodes included), {counts['groups']} flush groups, "
              f"{counts['dispatches']} detector dispatches, "
              f"{counts['rows']} rows; delivered "
              f"{rep['delivered_fps'].sum() / cfg.n_chunks:.1f} frames/s a "
              f"round (simulated)")
    a, b = reports["sync"], reports["batch_submit"]
    for k in SOAK_FIELDS:
        same = np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) \
            else a[k] == b[k]
        if not same:
            raise AssertionError(f"[serving] soak loss-burst: {k} differs "
                                 "between sync and batch_submit")
    print(f"[serving] soak loss-burst: sync == batch_submit in "
          f"{', '.join(SOAK_FIELDS)}")
    # shard-chaos: chunk-sequential, where each stream's dispatch is timed
    # on its own shard and the slow shard stands out; batch-submit, where
    # the two shards' batches differ in rows, reported as it comes
    chaos_cfg = FL.SoakConfig(**SOAK, n_shards=2)
    for mode in ("sync", "batch_submit"):
        counts, patch = _soak_split(EdgeRuntime)
        build.reset_launches()
        with patch:
            rep = FL.run_soak(chaos_cfg, FL.preset_schedule(
                "shard-chaos", n_chunks=cfg.n_chunks,
                n_streams=cfg.n_streams, n_shards=2, seed=cfg.seed),
                batch_submit=mode == "batch_submit")
        launches.update(build.LAUNCHES)
        acts = [x for _, x, _ in rep["fault_log"]]
        if not rep["accounting_ok"] or rep["queue_leaks"] \
                or rep["active_shards_final"] != [0, 1] \
                or counts["dispatches"] != counts["groups"] \
                or (mode == "sync" and acts != ["evict", "recover"]):
            raise AssertionError(
                f"[serving] soak shard-chaos {mode}: {rep['fault_log']}, "
                f"final {rep['active_shards_final']}, accounting "
                f"{rep['accounting_ok']}, {counts['dispatches']} dispatches "
                f"for {counts['groups']} flush groups")
        print(f"[serving] soak shard-chaos {mode} (2 logical shards): "
              f"{rep['wall_s'] * 1e3 / cfg.n_chunks:.1f} ms a round, "
              f"{counts['groups']} flush groups, {counts['dispatches']} "
              f"detector dispatches (one a group), "
              f"{rep['hedged_dispatches']} hedged; fault log "
              f"{rep['fault_log'] or 'empty: no shard flagged'}")

    # (3) one round with the ROI gate and the anchor search
    packets = _serving_packets(_streams(BATCHED_STREAMS))
    rt = EdgeRuntime(ServingConfig(n_streams=BATCHED_STREAMS,
                                   roi=RoiConfig(**ROI), anchor_search=True),
                     params, det_cfg)
    _round(rt, packets)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = _round(rt, packets, 1)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    got = dict(build.LAUNCHES)
    launches.update(got)
    _expect_launches("[serving] roi+search round", ROI_SEARCH_LAUNCHES)
    for boxes, scores, _ in res:
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError("[serving] roi+search: non-finite result")
    rt.close()
    print(f"[serving] roi+search: one batch-submit round {dt:.1f} ms, "
          f"launches {got}")

    # (4) the legacy decode against the fused
    pkt, gtb, gtv = packets[1]
    build.reset_launches()
    legacy = HD.decode_and_execute(pkt, params, det_cfg, gtb, gtv,
                                   bw_kbps=6000.0)
    _expect_launches("[serving] legacy decode_and_execute", LEGACY_LAUNCHES)
    launches.update(build.LAUNCHES)
    build.reset_launches()
    fused = HD.decode_and_execute_fused(pkt, params, det_cfg, gtb, gtv,
                                        bw_kbps=6000.0)
    _expect_launches("[serving] legacy decode_and_execute_fused",
                     LEGACY_LAUNCHES)
    launches.update(build.LAUNCHES)
    np.testing.assert_allclose(legacy.boxes, fused.boxes, rtol=0, atol=1e-2)
    np.testing.assert_allclose(legacy.scores, fused.scores, rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(legacy.f1, fused.f1)
    np.testing.assert_allclose(legacy.latency, fused.latency, rtol=1e-5)
    exact = np.array_equal(legacy.boxes, fused.boxes) \
        and np.array_equal(legacy.scores, fused.scores)
    print(f"[serving] legacy: one 720p packet (types "
          f"{[int((pkt.types == k).sum()) for k in (1, 2, 3)]}), "
          f"decode_and_execute vs decode_and_execute_fused: boxes and scores"
          f" {'bit for bit' if exact else 'within 1e-2 / 1e-4'}, F1 equal "
          f"({legacy.mean_f1:.4f}), latency {legacy.latency:.6f} vs "
          f"{fused.latency:.6f} s (host f64 vs device f32)")
    del packets, rt, res

    # (5) 64x96 packets on the card against the port's CPU path
    _serving_parity(params, det_cfg)
    return dict(launches), _serve_summary(r)


def _serve_summary(r: dict) -> dict:
    """A serve run's mean F1 and chunk latency (ms), its rounds (ms), the
    median of the later ones and its frames/s."""
    steady = statistics.median(r["rounds"][1:])
    return dict(f1=statistics.mean(r["out"]["f1"]),
                latency_ms=statistics.mean(r["out"]["latency"]) * 1e3,
                rounds=r["rounds"], steady_ms=steady,
                fps=BATCHED_STREAMS * T / steady * 1e3,
                serve_fps=r["out"]["fps"])


def _serving_parity(params, det_cfg) -> None:
    """64x96 packets encoded on the card and on the CPU (types, rungs,
    anchor qualities and MVs equal), then through a CUDA and a CPU
    runtime under a loss-burst schedule: types and stats exactly, boxes
    and scores within the [parity] contract; submit/flush/poll on the card
    against its process_chunk (types exactly, the rest within the
    contract)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.hybrid_encoder import encode_hybrid
    from repro_torch.serving import faults as FL
    from repro_torch.serving.runtime import EdgeRuntime
    from repro_torch.serving.scheduler import ServingConfig
    from repro_torch.sim.video_source import StreamConfig, generate_chunk
    cpu_params = {k: v.cpu() for k, v in params.items()}
    sched = FL.preset_schedule("loss-burst", n_chunks=12, n_streams=3)
    rts = {dev: EdgeRuntime(ServingConfig(n_streams=3), p, det_cfg,
                            faults=sched, device=dev)
           for dev, p in (("cuda", params), ("cpu", cpu_params))}
    batched = EdgeRuntime(ServingConfig(n_streams=3), params, det_cfg)
    oracle = EdgeRuntime(ServingConfig(n_streams=3), params, det_cfg)
    n_equal = n = b_equal = 0
    for t in range(4):
        pk = {}
        for c in range(3):
            raw = generate_chunk(StreamConfig(height=64, width=96,
                                              n_objects=3, seed=c), t * 4,
                                 4, device="cpu")[0]
            pk[c] = {dev: encode_hybrid(raw, 3000.0, 0.5, 0.02, device=dev)
                     for dev in ("cuda", "cpu")}
            g, h = pk[c]["cuda"], pk[c]["cpu"]
            if not (np.array_equal(g.types, h.types)
                    and (g.ladder_level, g.anchor_quality)
                    == (h.ladder_level, h.anchor_quality)
                    and torch.equal(g.video.mv.cpu(), h.video.mv)):
                raise AssertionError(f"[serving] parity encode {c} {t}")
            np.testing.assert_allclose(g.total_bits, h.total_bits,
                                       rtol=1e-4)
        for c in range(3):
            outs = {dev: rt.process_chunk(c, t, pk[c][dev])
                    for dev, rt in rts.items()}
            (gb, gs, gt), (hb, hs, ht) = outs["cuda"], outs["cpu"]
            np.testing.assert_array_equal(gt, ht)
            np.testing.assert_allclose(gs, hs, rtol=0, atol=1e-4)
            np.testing.assert_allclose(gb, hb, rtol=0, atol=1e-2)
            n_equal += np.array_equal(gb, hb) and np.array_equal(gs, hs)
            n += 1
        got = _round(batched, [(pk[c]["cuda"], None, None)
                               for c in range(3)], t)
        for c in range(3):
            (gb, gs, gt), (wb, ws, wt) = got[c], oracle.process_chunk(
                c, t, pk[c]["cuda"])
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-2)
            b_equal += np.array_equal(gb, wb) and np.array_equal(gs, ws)
    stats = {dev: {c: dataclasses.asdict(s) for c, s in rt.stats.items()}
             for dev, rt in rts.items()}
    if stats["cuda"] != stats["cpu"]:
        raise AssertionError("[serving] parity: stream stats differ")
    print(f"[serving] parity: 64x96, 3 streams x 4 chunks under loss-burst:"
          f" encodes equal in types, rungs, qualities and MVs; {n_equal} of "
          f"{n} chunks bit for bit the CPU runtime's, the rest within the "
          f"[parity] contract; stats equal; submit/flush/poll against "
          f"process_chunk on the card: {b_equal} of {n} bit for bit, the "
          "rest within the contract (a batch of 3 streams' rows against one "
          "stream's)")


def phase_profile_serving(params, det_cfg) -> None:
    """``--profile serving``: one batch-submit round of the nine streams
    (packets encoded beforehand) under torch.profiler, after two
    unprofiled rounds: busy share, device ops, host operators, and the
    device-to-host copies and bytes."""
    import pathlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.runtime import EdgeRuntime
    from repro_torch.serving.scheduler import ServingConfig
    packets = _serving_packets(_streams(BATCHED_STREAMS))
    rt = EdgeRuntime(ServingConfig(n_streams=BATCHED_STREAMS), params,
                     det_cfg)
    warm = []
    for t in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _round(rt, packets, t)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] serving: alone in a process, unprofiled rounds "
          f"{', '.join(f'{v:.1f}' for v in warm)} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _round(rt, packets, 2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sum(int(((p.types == 1) | (p.types == 2)).sum())
               for p, _, _ in packets)
    _print_profile(f"serving: one batch-submit round {BATCHED_STREAMS}x{T}x"
                   f"{H_HD}x{W_HD} ({rows} detector rows)", prof, wall)
    out_dir = pathlib.Path(ROOT) / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    n_bytes, n = _d2h_bytes(prof, out_dir / "serving_round.json")
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize"))
    result = sum(b.nbytes + s.nbytes for b, s, _ in res)
    print(f"[profile] serving: device-to-host copies in the round: {n} for "
          f"{len(res)} polls, " + (
              "bytes not measured (the trace gives none)" if n_bytes is None
              else f"{n_bytes} bytes ({n_bytes / 2**20:.2f} MiB; the results"
              f" are {result / 2**20:.2f} MiB)")
          + f"; {syncs} synchronising calls on the host")
    rt.close()


# [train]: the training stack on the card.  (a) the TinyDetector trained
# through train/loop.run on the streams serve.main serves
# (paper_stream_mix(9, 720, 1280), the reference's unscaled objects),
# 4-frame chunks in turns, fit_step's AdamW (quick_train's: lr 3e-3, 10
# warm-up steps), TRAIN_DET_STEPS steps (a minute or so of the card); saved in
# the reference's layout, restored bit for bit, served by
# serve.main --detector-ckpt; (b) llama3.2-1B at full width and depth on
# train_4k's 4096-token sequences, its batch cut from 256 to 2 and its
# grad_accum from 8 to 2, remat on, attention_impl "xla" (the reference's
# default: the kernel has no backward); (c) a supervised restart of the
# same widths cut to RESTART_LAYERS layers, in a process of its own with
# deterministic algorithms; (d) the kernels' grad guard on CUDA tensors
TRAIN_DET_STEPS = 2700
TRAIN_DET_LOG_POINTS = 12
LLAMA_TRAIN = dict(batch=2, seq_len=4096, grad_accum=2)
LLAMA_TRAIN_STEPS = 6
RESTART_LAYERS = 2
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 6, 2, 3
# grad_accum 2 against 1 on one batch: the same sums in another order and
# on other GEMM shapes, each half's bf16 gradient rounded on its own.  The
# loss and grad norm within these; AdamW's first moment mu (0.1 x the
# clipped gradient, the one state that carries the gradient's direction)
# within GA_MU_RTOL of each leaf's norm; and at least GA_SAME_SHARE of the
# updated params bit for bit (Adam's first step moves a weight by
# lr x sign(g): a dropped or doubled microbatch flips many signs)
GA_LOSS_RTOL = 1e-5
GA_NORM_RTOL = 1e-3
GA_MU_RTOL = 1e-2
GA_SAME_SHARE = 0.999
# mm_f32's differentiable CUDA GEMM against autograd through the widened
# f32 product on the same card: f32 sums in another order
MM_F32_RTOL = 1e-5


def _train_detector(det_cfg):
    """(a), training: returns (params, steps, wall s)."""
    import torch
    from repro_torch.launch.serve import fit_step
    from repro_torch.models import detection as D
    from repro_torch.sim.video_source import generate_chunk, paper_stream_mix
    from repro_torch.train import loop as LOOP
    from repro_torch.train.optimizer import AdamWConfig, init_state
    streams = paper_stream_mix(BATCHED_STREAMS, H_HD, W_HD)

    def data(n):
        for i in range(n):
            yield generate_chunk(streams[i % len(streams)], i * 4, 4)

    def fresh():
        params = D.init(torch.Generator().manual_seed(1), det_cfg)
        return {"params": params, "opt": init_state(params)}

    def make_step(n):
        ocfg = AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=10,
                           total_steps=n)

        def step(state, batch):
            p, o, loss = fit_step(state["params"], state["opt"], det_cfg,
                                  ocfg, *batch)
            return {"params": p, "opt": o}, {"loss": loss}
        return step

    n, k = TRAIN_DET_STEPS, TRAIN_DET_LOG_POINTS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = LOOP.run(make_step(n), fresh(), data(n),
                           LOOP.LoopConfig(total_steps=n, log_every=n // k))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"[train] detector: a non-finite loss {hist}")
    print(f"[train] detector: {n} steps of 4 frames of 720x1280 through "
          f"train/loop.run in {wall:.1f} s ({n / wall:.1f} steps/s); "
          f"loss by step: " + ", ".join(
              f"{h['step']}: {h['loss']:.4f}" for h in hist))
    return state["params"], n, wall


def _serve_trained(params, steps: int, quick) -> dict:
    """(a), serving: the checkpoint in the reference's layout, restored
    bit for bit, then serve.main --detector-ckpt on nine 720p streams.
    Returns the serve run's launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.models.weights import (detector_params_from_jax,
                                            detector_params_to_jax)
    from repro_torch.train import checkpoint as CKPT
    tmp = tempfile.mkdtemp(prefix="detector_ckpt_")
    try:
        like = detector_params_to_jax(params)
        CKPT.save(tmp, steps, like)
        nbytes = os.path.getsize(os.path.join(tmp, f"step_{steps}",
                                              "arrays.npz"))
        back = detector_params_from_jax(CKPT.restore(tmp, steps, like))
        differ = [k for k in params if not torch.equal(back[k], params[k])]
        if differ or back.keys() != params.keys():
            raise AssertionError(f"[train] detector checkpoint: restored "
                                 f"params differ in {differ}")
        print(f"[train] detector checkpoint: step {steps} in the "
              f"reference's layout (HWIO f32), {nbytes} bytes; restored bit "
              f"for bit ({len(params)} tensors)")
        r = _serve_run(SERVE_ARGV + ["--detector-ckpt", tmp])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if r["split"].calls["quick_train"]:
        raise AssertionError("[train] serve quick-trained after a restore")
    got = _serve_summary(r)
    print(f"[train] serve --detector-ckpt: rounds of {BATCHED_STREAMS} "
          f"streams x {T}x{H_HD}x{W_HD}: "
          f"{', '.join(f'{v:.1f}' for v in got['rounds'])} ms; median of the "
          f"later {got['steady_ms']:.1f} ms ({got['fps']:.1f} frames/s); "
          f"serve's own {got['serve_fps']:.1f} frames/s; mean F1 "
          f"{got['f1']:.4f}, mean chunk latency {got['latency_ms']:.1f} ms, "
          f"peak {r['peak'] / 2**30:.2f} GiB; launches over the run "
          f"{r['launches']} ({SERVE_LAUNCHES} each stream-chunk)")
    if quick is None:
        print("[train] the quick-train serve run: not run in this process")
    else:
        print(f"[train] beside [serving]'s quick-train serve run in this "
              f"process: mean F1 {quick['f1']:.4f}, mean chunk latency "
              f"{quick['latency_ms']:.1f} ms, median round "
              f"{quick['steady_ms']:.1f} ms ({quick['fps']:.1f} frames/s)")
    return r["launches"]


def _check_mm_f32(g) -> None:
    """(b), the one differentiable piece the training path adds on the
    card: mm_f32's CUDA GEMM with an f32 output and its backward, against
    autograd through the widened f32 product, at the LM's FFN shape and
    at an attention score's (batched)."""
    import torch
    from repro_torch.models import layers as L
    bf16 = torch.bfloat16
    for a_shape, b_shape in (((4096, 2048), (2048, 8192)),
                             ((2, 32, 512, 64), (2, 32, 64, 512))):
        a = torch.randn(a_shape, generator=g, device="cuda").to(bf16)
        b = (torch.randn(b_shape, generator=g, device="cuda") * 0.05).to(bf16)
        up = torch.randn((*a_shape[:-1], b_shape[-1]), generator=g,
                         device="cuda")
        outs = []
        for fn in (L.mm_f32, lambda x, y: torch.matmul(x.float(),
                                                       y.float())):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            out = fn(x, y)
            outs.append((out.detach(),
                         *torch.autograd.grad(out, (x, y), up)))
        (o, ga, gb), (ro, ra, rb) = outs
        gap = float((o - ro).abs().max() / ro.abs().max())
        # each gradient within one bf16 ulp of the widened product's
        ulp = [bool(((p.float() - q.float()).abs()
                     <= q.float().abs() * 2.0 ** -7).all())
               for p, q in ((ga, ra), (gb, rb))]
        if gap > MM_F32_RTOL or not all(ulp):
            raise AssertionError(f"[train] mm_f32 {a_shape} @ {b_shape}: "
                                 f"out gap {gap}, grads within an ulp {ulp}")
        same = ["bit for bit" if torch.equal(p, q) else "within an ulp"
                for p, q in ((ga, ra), (gb, rb))]
        print(f"[train] mm_f32 {a_shape} @ {b_shape} under autograd vs the "
              f"widened f32 product: out within {gap:.3g} of max "
              f"(tolerance {MM_F32_RTOL}), d/da {same[0]}, d/db {same[1]}")


def _train_llama() -> None:
    """(b): llama3.2-1B at full width and depth."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeCase, get_arch
    from repro_torch.launch import steps as S
    from repro_torch.models import params as PM
    from repro_torch.train import loop as LOOP
    arch = get_arch("llama3_2_1b")
    cfg = arch.cfg
    if not cfg.remat or cfg.attention_impl != "xla":
        raise AssertionError("[train] llama: expected remat and xla")
    case = ShapeCase("train_4k", "train", **LLAMA_TRAIN)
    B, S_ = case.batch, case.seq_len
    g = torch.Generator(device="cuda").manual_seed(0)
    _check_mm_f32(g)
    state, batch = S.materialize(g, arch, case)

    # the kernel path under autograd raises the guard's error
    pallas = dataclasses.replace(arch, cfg=dataclasses.replace(
        cfg, attention_impl="pallas"))
    try:
        S.make_train_fn(pallas)(state, {k: v[:1, :256]
                                        for k, v in batch.items()})
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"[train] llama with attention_impl='pallas', one step under "
              f"autograd: RuntimeError: {e}")
    else:
        raise AssertionError("[train] llama: the pallas step did not raise")

    # grad_accum 2 against 1 on one batch: grad_accum 1's params and mu
    # are kept, grad_accum 2's compared leaf by leaf as they come
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new1, m1 = S.make_train_fn(arch, 1)(state, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    p1, mu1 = new1["params"], new1["opt"]["mu"]
    del new1
    t0 = time.perf_counter()
    new2, m2 = S.make_train_fn(arch, 2)(state, batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter() - t0
    m1, m2 = ({k: float(v) for k, v in m.items()} for m in (m1, m2))
    loss_gap = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
    norm_gap = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    equal, total, mu_gap = 0, 0, 0.0
    for a, b in zip(PM.tree_leaves(new2["params"]), PM.tree_leaves(p1)):
        equal += int((a == b).sum())
        total += a.numel()
    for a, b in zip(PM.tree_leaves(new2["opt"]["mu"]), PM.tree_leaves(mu1)):
        mu_gap = max(mu_gap, float((a - b).norm() / b.norm()))
    print(f"[train] llama grad_accum 2 vs 1 on one batch of {B}x{S_}: loss "
          f"{m2['loss']:.6f} vs {m1['loss']:.6f} (gap {loss_gap:.3g}, "
          f"tolerance {GA_LOSS_RTOL}), grad norm {m2['grad_norm']:.5g} vs "
          f"{m1['grad_norm']:.5g} (gap {norm_gap:.3g}, tolerance "
          f"{GA_NORM_RTOL}), lr {m1['lr']:.3g}; mu's largest |d| / |mu| "
          f"over the leaves {mu_gap:.3g} (tolerance {GA_MU_RTOL}); updated "
          f"params {equal / total:.6f} bit for bit (at least "
          f"{GA_SAME_SHARE}); steps {t1 * 1e3:.1f} / {t2 * 1e3:.1f} ms "
          f"(first calls)")
    if loss_gap > GA_LOSS_RTOL or norm_gap > GA_NORM_RTOL \
            or not mu_gap <= GA_MU_RTOL or equal / total < GA_SAME_SHARE \
            or m1["lr"] != m2["lr"]:
        raise AssertionError("[train] llama: grad_accum 2 departs from 1")
    del new2, p1, mu1

    # LLAMA_TRAIN_STEPS steps through the loop, a fresh batch a step
    def data():
        while True:
            toks = torch.randint(0, cfg.vocab, (B, S_), generator=g,
                                 device="cuda", dtype=torch.int32)
            yield {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    step = S.make_train_fn(arch, case.grad_accum)
    times = []

    def timed(st, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(st, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    state, hist = LOOP.run(timed, state, data(), LOOP.LoopConfig(
        total_steps=LLAMA_TRAIN_STEPS, log_every=1))
    peak = torch.cuda.max_memory_allocated()
    if len(hist) != LLAMA_TRAIN_STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist):
        raise AssertionError(f"[train] llama: losses {hist}")
    med = statistics.median(times[1:])
    tokens = B * S_
    n_params = cfg.param_count()
    flops = 6 * n_params * tokens
    losses = _losses(hist)
    norms = ", ".join(f"{h['grad_norm']:.4g}" for h in hist)
    print(f"[train] llama3.2-1B train: {LLAMA_TRAIN_STEPS} steps of {B}x{S_}"
          f" tokens, grad_accum {case.grad_accum}, remat, xla attention: "
          f"losses {losses}; grad norms {norms}")
    print(f"[train] llama3.2-1B train: step times "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of the "
          f"later {med * 1e3:.1f} ms, {tokens / med:.1f} tokens/s; 6 N tokens "
          f"= {flops:.4g} FLOP a step (N = {n_params:,}, the recompute not "
          f"counted) = {flops / med / 1e12:.1f} TFLOP/s, "
          f"{flops / med / BF16_TC_OPS_PER_S * 100:.2f} % of 989 TFLOP/s; "
          f"peak {peak / 2**30:.2f} GiB")


def _losses(hist) -> str:
    return ", ".join(f"{h['loss']:.4f}" for h in hist)


def phase_train_restart() -> None:
    """(c), ``--train-restart`` in a process of its own (CUBLAS_WORKSPACE_
    CONFIG set before CUDA starts): fault_tolerance.supervise at
    llama3.2-1B's widths cut to RESTART_LAYERS layers, a checkpoint every
    RESTART_EVERY steps (keep 1) under a temporary directory, a failure
    injected at step RESTART_FAIL_AT; the final state against an
    uninterrupted run's, bit for bit, under
    torch.use_deterministic_algorithms (an op without a deterministic form
    raises)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import ShapeCase, get_arch
    from repro_torch.launch import steps as S
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import loop as LOOP
    torch.use_deterministic_algorithms(True)
    full = get_arch("llama3_2_1b")
    arch = dataclasses.replace(full, cfg=dataclasses.replace(
        full.cfg, n_layers=RESTART_LAYERS))
    case = ShapeCase("train_4k", "train", **LLAMA_TRAIN)
    step = S.make_train_fn(arch, case.grad_accum)

    def initial():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return S.materialize(gen, arch, case)[0]

    def batches(start):
        """Batch i from seed 100 + i: a resumed run reads what an
        uninterrupted one would."""
        for i in range(start, RESTART_STEPS):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            toks = torch.randint(0, arch.cfg.vocab, (case.batch,
                                                     case.seq_len),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            yield {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    timing = {"save": [], "restore": []}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[name].append(time.perf_counter() - t0)
            return out
        return call

    tmp = tempfile.mkdtemp(prefix="restart_ckpt_")
    restarts = []
    try:
        cfg = LOOP.LoopConfig(total_steps=RESTART_STEPS, ckpt_dir=tmp,
                              ckpt_every=RESTART_EVERY, log_every=1, keep=1)
        with _patched((CKPT, "save", timed("save", CKPT.save)),
                      (CKPT, "restore", timed("restore", CKPT.restore))):
            res = FT.supervise(
                lambda attempt: (step, initial(), None),
                lambda: batches(CKPT.latest_step(tmp) or 0), cfg,
                fail_injector=lambda s: s == RESTART_FAIL_AT,
                on_restart=lambda n: restarts.append(CKPT.latest_step(tmp)))
            nbytes = os.path.getsize(os.path.join(
                tmp, f"step_{RESTART_STEPS}", "arrays.npz"))
            free = shutil.disk_usage(tmp).free
            state, hist = LOOP.run(step, initial(), batches(0),
                                   LOOP.LoopConfig(total_steps=RESTART_STEPS,
                                                   log_every=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if res.restarts != 1 or restarts != [RESTART_EVERY]:
        raise AssertionError(f"[train] restart: {res.restarts} restarts "
                             f"from steps {restarts}")
    pairs = list(zip(CKPT._flatten(res.state), CKPT._flatten(state)))
    differ = [ka for (ka, a), (_, b) in pairs if not torch.equal(a, b)]
    print(f"[train] restart: llama3.2-1B widths, {RESTART_LAYERS} of 16 "
          f"layers, {case.batch}x{case.seq_len} tokens a step, grad_accum "
          f"{case.grad_accum}: {RESTART_STEPS} steps, a checkpoint every "
          f"{RESTART_EVERY}, failure injected at step {RESTART_FAIL_AT}: "
          f"{res.restarts} restart from step {restarts[0]}; losses "
          f"{_losses(res.history)} (the uninterrupted run's "
          f"{_losses(hist)})")
    print(f"[train] restart: checkpoint {nbytes} bytes ({nbytes / 2**30:.2f} "
          f"GiB; {free / 2**30:.1f} GiB free there); save "
          f"{', '.join(f'{t:.2f}' for t in timing['save'])} s, restore "
          f"{', '.join(f'{t:.2f}' for t in timing['restore'])} s")
    if differ:
        raise AssertionError(f"[train] restart: {len(differ)} of "
                             f"{len(pairs)} tensors differ from the "
                             f"uninterrupted run's: {differ}")
    print(f"[train] restart: final params and optimiser state bit for bit "
          f"the uninterrupted run's ({len(pairs)} tensors; deterministic "
          f"algorithms on)")


def _check_grad_guard() -> None:
    """(d): every kernel wrapper on CUDA tensors raises under autograd
    with an argument that requires grad, then runs without."""
    import torch
    from repro_torch.kernels.blockdct import ops as BD
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.motion_sad.ops import motion_sad
    from repro_torch.kernels.qtransfer.ops import qtransfer
    from repro_torch.kernels.roi_gather.ops import roi_gather
    from repro_torch.kernels.seq_sum.ops import seq_sum
    from repro_torch.codec.blockdct import dct_matrix, quant_table
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    dmat, qtab = dct_matrix(8, dev), quant_table(50.0, dev)
    mv = torch.zeros((1, 2, 2, 2), dtype=torch.int32, device=dev)
    idx = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    calls = {
        "flash_attention": (lambda x: flash_attention(x, x, x, causal=True),
                            r(1, 64, 2, 64).to(torch.bfloat16)),
        "motion_sad": (lambda x: motion_sad(x, x, 2), r(32, 32) * 255),
        "blockdct.forward_quant": (lambda x: BD.forward_quant(x, dmat, qtab),
                                   r(3, 8, 8) * 255),
        "blockdct.forward_quant_raster": (
            lambda x: BD.forward_quant_raster(x, dmat, qtab),
            r(2, 16, 16) * 255),
        "blockdct.inverse": (lambda x: BD.inverse(x, dmat, qtab),
                             r(3, 8, 8)),
        "blockdct.inverse_raster": (
            lambda x: BD.inverse_raster(x, dmat, qtab, 16, 16),
            r(2, 4, 8, 8)),
        "qtransfer": (lambda x: qtransfer(x, mv, x), r(1, 32, 32)),
        "roi_gather": (lambda x: roi_gather(x, idx, idx, region_px=8,
                                            halo=2), r(1, 20, 20)),
        "seq_sum": (seq_sum, r(2, 3, 4)),
    }
    for name, (call, x) in calls.items():
        try:
            call(x.clone().requires_grad_())
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"[train] {name} ran under autograd")
        call(x)
    torch.cuda.synchronize()
    print(f"[train] grad guard on CUDA: each of {len(calls)} wrappers "
          f"({', '.join(calls)}) raised under autograd and ran without")


def train_restart_in_child() -> None:
    """(c) in a fresh process, its lines printed here."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--train-restart"], capture_output=True, text=True,
                         timeout=900, env=env)
    print(res.stdout, end="")
    if res.returncode != 0:
        raise RuntimeError(f"[train] restart failed:\n{res.stderr[-6000:]}")


def phase_train(quick) -> dict:
    """[train] (a)-(d); ``quick`` is [serving]'s quick-train serve run to
    print beside the trained detector's (None when [serving] did not run).
    Returns the launches of the detector's serve run."""
    import torch
    from repro_torch.models.detection import TinyDetectorConfig
    det_cfg = TinyDetectorConfig()
    t0 = time.perf_counter()
    params, steps, _ = _train_detector(det_cfg)
    launches = _serve_trained(params, steps, quick)
    del params
    torch.cuda.empty_cache()
    _train_llama()
    torch.cuda.empty_cache()
    train_restart_in_child()
    _check_grad_guard()
    print(f"[train] phase wall {time.perf_counter() - t0:.1f} s")
    return launches


# [dryrun]: every cell of all_cells() laid out on the single production
# mesh of meta devices (baseline rules); then three cells materialised on
# the card and held to their layout on a 1x1 meta mesh: the llama3.2-1B
# train step at [train]'s cut, ResNet-50 serve_b128, DiT-XL/2 gen_fast.
# The arguments' storage equals the layout's bytes exactly, and the
# allocator grows by that within its rounding: 512 bytes a block, and a
# block of 1 MiB or more cut from a larger segment keeps a tail under
# 1 MiB that is not worth splitting off.  The FLOPs counted over the step
# on the card equal the meta count exactly
CARD_BYTES = 80 * 2**30
DRYRUN_HOLDS = (("llama3_2_1b", "train_4k", LLAMA_TRAIN),
                ("resnet_50", "serve_b128", None),
                ("dit_xl2", "gen_fast", None))
DRYRUN_REPS = {"llama3_2_1b": 3, "resnet_50": 10, "dit_xl2": 5}
DRYRUN_ALLOC_ROUND = 512
DRYRUN_ALLOC_TAIL = 2**20


def _dryrun_sweep() -> None:
    """Every cell of ``all_cells()`` through ``dryrun.run_cell`` on the
    single mesh, baseline; an error raises."""
    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    n = 0
    for arch_id, shape, _ in all_cells():
        rec = D.run_cell(arch_id, shape, "single", "baseline", None)
        if rec["status"] == "skipped":
            print(f"[dryrun] {arch_id} {shape}: skipped ({rec['reason']})")
            continue
        n += 1
        arg = rec["memory"]["argument_size_in_bytes"]
        out = rec["memory"]["output_size_in_bytes"]
        print(f"[dryrun] {arch_id} {shape}: {arg / 2**30:.3f} GiB of "
              f"arguments a device ({arg / CARD_BYTES * 100:.2f} % of the "
              f"card's 80 GiB), outputs {out / 2**30:.3f} GiB; "
              f"{rec['cost_global']['flops']:.4g} FLOP a step "
              f"({rec['cost']['flops']:.4g} a device of "
              f"{rec['n_devices']}, {rec['cost_method']}); layout "
              f"{rec['layout_s']:.2f} s, walk {rec['total_s']:.2f} s")
    print(f"[dryrun] {n} cells laid out on the single mesh in "
          f"{time.perf_counter() - t0:.1f} s")


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages under the tensors of ``tree``."""
    import torch
    from repro_torch.launch.dryrun import path_leaves
    seen = {}
    for _, t in path_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _dryrun_hold(arch_id: str, shape: str, cut, card: str) -> None:
    """One cell materialised on the card against its layout on a 1x1 meta
    mesh: the storage and the allocator's growth against the argument
    bytes, the FLOPs counted over the step on the card against the meta
    count (op by op where they differ), the step's median wall and the
    share of 989 TFLOP/s it gives."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import make_axis_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    arch = get_arch(arch_id)
    case = arch.shapes[shape]
    if cut is not None:
        case = dataclasses.replace(case, **cut)
    tag = f"[dryrun] hold {arch_id} {shape}" + (
        f" cut to {case.batch}x{case.seq_len}, grad_accum "
        f"{case.grad_accum}" if cut else "")
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("meta")])
    rec = D.layout(arch, case, mesh, make_axis_rules(False))
    want = rec["memory"]["argument_size_in_bytes"]
    flops = rec["cost_global"]["flops"]

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(0)
    args = S.materialize(g, arch, case)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    stored = _storage_bytes(args)
    sizes = [t.untyped_storage().nbytes() for _, t in D.path_leaves(args)
             if isinstance(t, torch.Tensor)]
    slack = DRYRUN_ALLOC_ROUND * len(sizes) + DRYRUN_ALLOC_TAIL * sum(
        n >= DRYRUN_ALLOC_TAIL for n in sizes)
    print(f"{tag}: arguments {stored:,} bytes of storage against the "
          f"layout's {want:,}; the allocator grew {grown:,} bytes, "
          f"{grown - want:,} over ({len(sizes)} tensors: at most "
          f"{slack:,} of rounding)")
    if stored != want or not 0 <= grown - want <= slack:
        raise AssertionError(f"{tag}: the card's arguments depart from "
                             f"the layout")

    fn = S.build_cell(arch, case).fn
    with D.flop_counter() as fc:
        fn(*args)
        torch.cuda.synchronize()
    got = fc.get_total_flops()
    by_op = {str(op): n for op, n in
             fc.get_flop_counts().get("Global", {}).items()}
    gaps = {op: (by_op.get(op, 0), rec["flops_by_op"].get(op, 0))
            for op in set(by_op) | set(rec["flops_by_op"])
            if by_op.get(op, 0) != rec["flops_by_op"].get(op, 0)}
    print(f"{tag}: {got:.6g} FLOP counted on the card, {flops:.6g} on meta "
          f"({rec['cost_method']}); by operator on the card "
          f"{sorted(by_op.items())}"
          + (f"; differing (card, meta): {gaps}" if gaps else ", equal"))
    if got != flops:
        raise AssertionError(f"{tag}: FLOPs on the card {got} != meta "
                             f"{flops}: {gaps}")

    ms = _zoo_ms(lambda: fn(*args), DRYRUN_REPS[arch_id])
    share = flops / (ms / 1e3) / BF16_TC_OPS_PER_S
    extra = ""
    if arch.family == "lm":
        six = 6 * arch.cfg.param_count() * case.batch * case.seq_len
        extra = (f"; [train]'s 6 N tokens = {six:.4g} FLOP gives "
                 f"{six / (ms / 1e3) / BF16_TC_OPS_PER_S * 100:.2f} % (the "
                 f"meta count is {flops / six:.3f}x: the recompute and the "
                 f"attention)")
    print(f"{tag}: median step {ms:.2f} ms of {DRYRUN_REPS[arch_id]} after "
          f"a warm-up, {flops / (ms / 1e3) / 1e12:.2f} TFLOP/s = "
          f"{share * 100:.2f} % of 989 TFLOP/s ({card}){extra}")
    del args
    torch.cuda.empty_cache()


def phase_dryrun(card: str) -> None:
    """[dryrun]: the sweep, then the three holds."""
    t0 = time.perf_counter()
    _dryrun_sweep()
    for arch_id, shape, cut in DRYRUN_HOLDS:
        _dryrun_hold(arch_id, shape, cut, card)
    print(f"[dryrun] phase wall {time.perf_counter() - t0:.1f} s")


def _print_kernel(k: dict) -> None:
    """One [kernels] line: times, bound and host time of a kernel form."""
    lib = "" if k["library_ms"] is None \
        else f", library {k['library_ms'] * 1e3:.1f} us"
    host = f", host {k['host_ms'] * 1e3:.1f} us a call" \
        if "host_ms" in k else ""
    device = f", device {k['device_ms'] * 1e3:.1f} us a launch (CUDA " \
        "graph)" if "device_ms" in k else ""
    turns = "" if len(k.get("ms_turns", ())) < 2 else (
        "; again: " + ", ".join(
            f"{k[key][1] * 1e3:.1f}" for key in
            ("ms_turns", "device_ms_turns", "host_ms_turns")) + " us")
    print(f"[kernels] {k['name']} ({k['shape']}): {k['ms'] * 1e3:.1f} us,"
          f" plain {k['plain_ms'] * 1e3:.1f} us{lib}, bound "
          f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}){device}{host}"
          f"{turns}")


def profile_in_child(tag: str) -> None:
    """``phase_profile`` of one path in a fresh process; its lines are
    printed here."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--profile", tag], capture_output=True, text=True,
                         timeout=600)
    print(res.stdout, end="")
    if res.returncode != 0:
        raise RuntimeError(f"profile of {tag} failed:\n{res.stderr}")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.models.detection import TinyDetectorConfig, init

    resolve_device()
    det_cfg = TinyDetectorConfig()
    params = init(torch.Generator().manual_seed(1), det_cfg)
    paths = path_configs(det_cfg)
    if argv[:1] == ["--sharded"]:
        # stream sharding alone, e.g. on a machine with several cards
        phase_card()
        phase_build()
        check_threaded_launch()
        phase_sharded(params, det_cfg)
        return 0
    if argv[:1] == ["--seq-sum"]:
        # the seq_sum kernel alone: the card line, its build, its checks
        # and times
        card = phase_card()
        phase_build(("seq_sum",))
        for k in check_seq_sum(torch.Generator(device="cuda").manual_seed(0)):
            _print_kernel(k)
        print(card)
        return 0
    if argv[:1] == ["--train-restart"]:
        phase_train_restart()
        return 0
    if argv[:1] == ["--train"]:
        # the training phase alone (with the card line and the build)
        card = phase_card()
        phase_build()
        phase_train(None)
        print(card)
        return 0
    if argv[:1] == ["--moe-sharded"]:
        # the expert-parallel branch alone, e.g. on a machine with several
        # cards
        card = phase_card()
        phase_build()
        phase_moe_sharded()
        print(card)
        return 0
    if argv[:1] == ["--moe"]:
        # the MoE phase alone, with the card line, the build and its two
        # flash_attention forms
        card = phase_card()
        phase_build()
        check_flash_sweep(torch.Generator(device="cuda").manual_seed(1))
        kernels = check_flash_attention(
            torch.Generator(device="cuda").manual_seed(0),
            labels=[k for k, v in FLASH_FORM_PATHS.items()
                    if v in ("moe", "mixtral")])
        launches = phase_moe()
        profile_in_child("moe")
        for k in kernels:
            _print_kernel(k)
            k["path"] = k["form_path"]
            k["launches"] = k["form_launches"] = \
                launches[k["path"]][k["name"]]
        print(card)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv[:1] == ["--zoo"]:
        # the vision and diffusion zoo alone, with the card line
        card = phase_card()
        phase_zoo(card)
        profile_in_child("zoo")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv[:1] == ["--dryrun"]:
        # the dry-run tooling alone, with the card line
        card = phase_card()
        phase_dryrun(card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv[:1] == ["--profile"]:
        if argv[1] == "lm":
            phase_profile_lm()
        elif argv[1] == "zoo":
            phase_profile_zoo()
        elif argv[1] == "moe":
            phase_profile_moe()
        elif argv[1] == "batched":
            phase_profile_batched(params, det_cfg)
        elif argv[1] == "control":
            phase_profile_control(params, det_cfg)
        elif argv[1] == "serving":
            phase_profile_serving(params, det_cfg)
        else:
            phase_profile(argv[1], params, paths[argv[1]][0])
        return 0

    card = phase_card()
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()

    # the sweep draws from a generator of its own, so that the timed forms
    # get the same inputs with or without it
    check_flash_sweep(torch.Generator(device="cuda").manual_seed(1))
    check_motion_sad_sweep(torch.Generator(device="cuda").manual_seed(2))
    check_blockdct_sweep(torch.Generator(device="cuda").manual_seed(3))
    check_qtransfer_sweep(torch.Generator(device="cuda").manual_seed(4))
    g = torch.Generator(device="cuda").manual_seed(0)
    kernels = [*check_motion_sad(g), *check_blockdct(g),
               check_blockdct_tables(g), *check_seq_sum(g),
               *check_qtransfer(g), check_roi_gather(g),
               *check_flash_attention(g)]
    for k in kernels:
        _print_kernel(k)

    check_threaded_launch()

    launches = run_paths(params, paths)
    for tag in paths:
        profile_in_child(tag)
    phase_admit_all(params, paths["roi"][0])
    launches["parity"] = phase_small_parity(params, det_cfg)
    launches.update(phase_batched(params, det_cfg))
    profile_in_child("batched")
    launches["sharded"] = phase_sharded(params, det_cfg)
    launches.update(phase_control(params, det_cfg))
    profile_in_child("control")
    launches["serving"], quick = phase_serving(params, det_cfg)
    profile_in_child("serving")
    launches["train"] = phase_train(quick)
    del params
    launches["lm"] = phase_lm()
    profile_in_child("lm")
    launches["chatglm3"] = phase_chatglm3()
    torch.cuda.empty_cache()
    launches.update(phase_moe())
    profile_in_child("moe")
    torch.cuda.empty_cache()
    phase_zoo(card)
    profile_in_child("zoo")
    torch.cuda.empty_cache()
    phase_dryrun(card)

    # each kernel's launches from the first path that runs it (the bf16
    # qtransfer is on no path: the reference reaches it only from its
    # kernel tests and benchmarks); the flash_attention forms share one
    # counter, and each also gives its own launches on the path that runs
    # that very form, if one does (form_path, form_launches)
    for k in kernels:
        k["path"] = next((p for p, n in launches.items()
                          if n.get(k["name"])), None)
        k["launches"] = launches[k["path"]][k["name"]] if k["path"] else 0
        k["sharded_launches"] = launches["sharded"].get(k["name"], 0)
        if "form_path" in k:
            k["form_launches"] = launches[k["form_path"]][k["name"]] \
                if k["form_path"] else 0
    unlaunched = {k["name"] for k in kernels} \
        - {name for n in launches.values() for name in n if n[name]}
    if unlaunched - {"qtransfer_bf16"}:
        raise AssertionError(f"launched on no path: {sorted(unlaunched)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
