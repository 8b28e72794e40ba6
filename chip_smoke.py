#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        (from the repo root; needs one CUDA card)

Phases, each printing its own lines; any failure raises and exits non-zero:

1. card: name and power limit from nvidia-smi;
2. build: compiles the port's CUDA kernels (``src/repro_torch/kernels/csrc``)
   with nvcc, one process per source;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with its time, the plain version's time and
   its bound (CUDA events, median of 20 timed runs after warm-up);
4. main path: ``roundtrip_chunk`` on 720x1280 sources, 30-frame chunks,
   ladder rung 2 (LR 352x640), full-width TinyDetector from the port's
   ``init``: 2 streams x 3 consecutive chunks.  Launch counters show the
   path went through every kernel, and a 64x96 chunk on the card is
   held against the port's plain CPU path;
5. profile: one more chunk under torch.profiler (device busy share and
   time by kernel);
6. one JSON line listing the kernels; 7. the JSON result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores.  TF32 is off in the port.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4

H_HD, W_HD, T = 720, 1280, 30          # one second of 720p at 30 fps
LEVEL = 2                              # ladder rung 2: LR 352x640
RADIUS = 8
# Eq. 3 thresholds of the main path: on these streams they give all three
# pipelines (the sparse stream) and anchors at every other frame (the
# dense one)
TR1, TR2 = 0.06, 0.015


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    dt = time.perf_counter() - t0
    print(f"[build] {len(reports)} kernel libraries built in {dt:.2f} s "
          f"into {build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _sad_f64(cur, ref, by, bx, dy, dx, radius):
    """One block's SAD at offset (dy, dx) in f64 on the host, against the
    edge-padded reference."""
    import numpy as np
    H, W = ref.shape
    ys = np.clip(np.arange(by * 16, by * 16 + 16) + dy, 0, H - 1)
    xs = np.clip(np.arange(bx * 16, bx * 16 + 16) + dx, 0, W - 1)
    c = cur[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].astype(np.float64)
    return float(np.abs(c - ref[np.ix_(ys, xs)].astype(np.float64)).sum())


def check_motion_sad(g) -> dict:
    import torch
    from repro_torch.kernels.motion_sad.ops import motion_sad, \
        motion_sad_plain
    h, w = 352, 640
    dev = torch.device("cuda")
    base = torch.rand((h + 32, w + 32), generator=g, device=dev) * 255
    # a frame and its shifted, noisier successor, integer- and float-valued
    cases = {}
    ref_f = base[16:16 + h, 16:16 + w].contiguous()
    cur_f = (base[13:13 + h, 18:18 + w]
             + torch.randn((h, w), generator=g, device=dev) * 3).contiguous()
    cases["integer"] = (cur_f.round(), ref_f.round())
    cases["float"] = (cur_f, ref_f)
    max_err = 0.0
    for label, (cur, ref) in cases.items():
        mv, sad = motion_sad(cur, ref, RADIUS)
        mv_p, sad_p = motion_sad_plain(cur, ref, RADIUS)
        torch.cuda.synchronize()
        diff = (mv != mv_p).any(-1)
        n_diff = int(diff.sum())
        if label == "integer":
            if n_diff or not torch.equal(sad, sad_p):
                raise AssertionError(
                    f"motion_sad integer input: {n_diff} MVs differ, max "
                    f"|dsad| {float((sad - sad_p).abs().max())}")
        else:
            c, r = cur.cpu().numpy(), ref.cpu().numpy()
            for by, bx in diff.nonzero().tolist():
                a = _sad_f64(c, r, by, bx, *mv[by, bx].tolist(), RADIUS)
                b = _sad_f64(c, r, by, bx, *mv_p[by, bx].tolist(), RADIUS)
                if abs(a - b) > 1e-5 * max(abs(a), abs(b)):
                    raise AssertionError(
                        f"motion_sad float input: block ({by},{bx}) picked "
                        f"{mv[by, bx].tolist()} (f64 SAD {a}) where the plain "
                        f"version picked {mv_p[by, bx].tolist()} ({b})")
            same = ~diff
            rel = ((sad - sad_p).abs()[same]
                   / sad_p.abs()[same].clamp(min=1e-6)).max()
            if float(rel) > 1e-5:
                raise AssertionError(f"motion_sad float SAD rel err {rel}")
        err = float((sad - sad_p).abs()[~diff].max())
        max_err = max(max_err, err)
        print(f"[kernels] motion_sad {label:7s} {h}x{w} R={RADIUS}: "
              f"{n_diff} MVs differ, max |dsad| (same MV) {err:.3g}")
    cur, ref = cases["float"]
    ms = cuda_ms(lambda: motion_sad(cur, ref, RADIUS))
    plain = cuda_ms(lambda: motion_sad_plain(cur, ref, RADIUS), reps=5,
                    inner=1, warmup=1)
    nb = (h // 16) * (w // 16)
    cands = (2 * RADIUS + 1) ** 2
    b, by = bound_ms(2 * h * w * F32 + nb * 3 * F32, nb * cands * 256 * 2)
    return dict(name="motion_sad", mode="exhaustive f32",
                route="cuda", source="src/repro_torch/kernels/csrc/motion_sad.cu",
                replaces="src/repro/kernels/motion_sad/kernel.py:159",
                max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None,
                shape=f"{h}x{w} R={RADIUS}")


def check_blockdct(g) -> list[dict]:
    import torch
    from repro_torch.codec.blockdct import dct_matrix, quant_table
    from repro_torch.kernels.blockdct import ops
    dev = torch.device("cuda")
    D = dct_matrix(8, dev)
    nb = T * (H_HD // 8) * (W_HD // 8)             # the anchor batch
    blocks = torch.rand((nb, 8, 8), generator=g, device=dev) * 255 - 128
    fwd_err = 0.0
    for quality in (50.0, 70.0):
        qt = quant_table(quality, dev)
        q, rec = ops.forward_quant(blocks, D, qt)
        qp, recp = ops.forward_quant_plain(blocks, D, qt)
        torch.cuda.synchronize()
        dq = (q - qp).abs()
        agree = (dq == 0).flatten(1).all(1)
        err = float((rec - recp).abs()[agree].max())
        print(f"[kernels] blockdct forward q{quality:.0f} {nb} blocks: "
              f"max|dq| {float(dq.max())}, mean|dq| {float(dq.mean()):.2e}, "
              f"max|drec| where q agrees {err:.3g}")
        if float(dq.max()) > 1 or float(dq.mean()) >= 0.01 or err > 1e-3:
            raise AssertionError("blockdct forward disagrees with its plain "
                                 "version")
        fwd_err = max(fwd_err, err)
    qt = quant_table(70.0, dev)
    fwd_ms = cuda_ms(lambda: ops.forward_quant(blocks, D, qt))
    fwd_plain = cuda_ms(lambda: ops.forward_quant_plain(blocks, D, qt))
    b_f, by_f = bound_ms(3 * nb * 64 * F32, nb * 4 * 8 * 8 * 8 * 2)

    # the decoder's inverse over the LR residuals of one chunk
    nb_inv = T * (352 // 8) * (640 // 8)
    q_inv, _ = ops.forward_quant_plain(blocks[:nb_inv].contiguous(), D, qt)
    rec = ops.inverse(q_inv, D, qt)
    recp = ops.inverse_plain(q_inv, D, qt)
    torch.cuda.synchronize()
    inv_err = float((rec - recp).abs().max())
    print(f"[kernels] blockdct inverse {nb_inv} blocks: max|drec| "
          f"{inv_err:.3g}")
    if inv_err > 1e-3:
        raise AssertionError("blockdct inverse disagrees with its plain "
                             "version")
    inv_ms = cuda_ms(lambda: ops.inverse(q_inv, D, qt))
    inv_plain = cuda_ms(lambda: ops.inverse_plain(q_inv, D, qt))
    b_i, by_i = bound_ms(2 * nb_inv * 64 * F32, nb_inv * 2 * 8 * 8 * 8 * 2)
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/blockdct.cu",
                  replaces="src/repro/kernels/blockdct/kernel.py:41",
                  library_ms=None)
    return [dict(name="blockdct_forward", mode="forward_quant",
                 max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
                 bound_ms=b_f, bound_by=by_f, shape=f"{nb} blocks", **common),
            dict(name="blockdct_inverse", mode="inverse",
                 max_abs_err=inv_err, ms=inv_ms, plain_ms=inv_plain,
                 bound_ms=b_i, bound_by=by_i, shape=f"{nb_inv} blocks",
                 **common)]


def check_qtransfer(g) -> dict:
    import torch
    from repro_torch.kernels.qtransfer.ops import qtransfer, qtransfer_plain
    dev = torch.device("cuda")
    shape = (T, H_HD, W_HD)
    anchor = torch.rand(shape, generator=g, device=dev) * 255
    resid = torch.randn(shape, generator=g, device=dev) * 8
    mv = torch.randint(-24, 25, (T, H_HD // 16, W_HD // 16, 2), generator=g,
                       device=dev, dtype=torch.int32)
    max_err = 0.0
    for edge in ("pixel", "block"):
        for r in (None, resid):
            out = qtransfer(anchor, mv, r, edge=edge)
            ref = qtransfer_plain(anchor, mv, r, edge=edge)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            label = "gather" if r is None else "gather+resid+clip"
            print(f"[kernels] qtransfer edge={edge} {label} "
                  f"{'x'.join(map(str, shape))} |mv|<=24: max err {err}")
            if err != 0.0:
                raise AssertionError(f"qtransfer edge={edge} is not exact")
            max_err = max(max_err, err)
    ms = cuda_ms(lambda: qtransfer(anchor, mv, resid, edge="pixel"))
    plain = cuda_ms(lambda: qtransfer_plain(anchor, mv, resid, edge="pixel"))
    n = math.prod(shape)
    b, by = bound_ms(3 * n * F32 + mv.numel() * 4, 2 * n)
    return dict(name="qtransfer", mode="pixel (main path) and block",
                route="cuda", source="src/repro_torch/kernels/csrc/qtransfer.cu",
                replaces="src/repro/kernels/qtransfer/kernel.py:50",
                max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None,
                shape="x".join(map(str, shape)) + " pixel+resid")


def _streams():
    from repro_torch.sim.video_source import StreamConfig
    # the reference's paper_stream_mix (one sparse, one dense stream),
    # object sizes and speeds scaled from its 96-px frames to 720 px
    k = H_HD / 96
    return [StreamConfig(name="sparse_0", height=H_HD, width=W_HD,
                         n_objects=3, min_size=int(20 * k),
                         max_size=int(32 * k), speed=1.5 * k, seed=100),
            StreamConfig(name="dense_1", height=H_HD, width=W_HD,
                         n_objects=12, min_size=int(10 * k),
                         max_size=int(16 * k), speed=3.0 * k, seed=201)]


def phase_main_path(params, det_cfg) -> tuple[dict, list]:
    import torch
    from repro_torch.core.roundtrip import RoundtripConfig, roundtrip_chunk
    from repro_torch.kernels import build
    from repro_torch.sim.video_source import generate_chunk
    cfg = RoundtripConfig(level=LEVEL, det_cfg=det_cfg)
    inputs = [[generate_chunk(sc, c * T, T) for c in range(3)]
              for sc in _streams()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_ms = []
    build.reset_launches()
    for s, chunks in enumerate(inputs):
        for c, (raw, gtb, gtv) in enumerate(chunks):
            t0 = time.perf_counter()
            out = roundtrip_chunk(raw, gtb, gtv, params, tr1=TR1, tr2=TR2,
                                  bw_kbps=6000.0, cfg=cfg)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            chunk_ms.append(dt)
            types = out["types"]
            for k, v in out.items():
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    raise AssertionError(f"stream {s} chunk {c}: {k} is not "
                                         "finite")
            if int(types[0]) != 1 or out["boxes"].shape != (
                    T, (H_HD // 8) * (W_HD // 8), 4):
                raise AssertionError(f"stream {s} chunk {c}: bad output "
                                     f"(types[0]={int(types[0])}, boxes "
                                     f"{tuple(out['boxes'].shape)})")
            mix = [int((types == k).sum()) for k in (1, 2, 3)]
            print(f"[main] stream {s} chunk {c}: {dt:.1f} ms "
                  f"({T / dt * 1e3:.1f} frames/s), pipelines {mix}, "
                  f"mean_f1 {float(out['mean_f1']):.4f}, bits "
                  f"{float(out['total_bits']):.0f}, latency "
                  f"{float(out['latency']):.4f} s")
    launches = dict(build.LAUNCHES)
    n_chunks = len(chunk_ms)
    per_chunk = {"motion_sad": T - 1, "blockdct_forward": T + 1,
                 "blockdct_inverse": 1, "qtransfer": T}
    print(f"[main] launches over {n_chunks} chunks: {launches}; per chunk: "
          f"{ {k: v / n_chunks for k, v in launches.items()} }")
    for name, n in per_chunk.items():
        if launches.get(name, 0) != n * n_chunks:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches, "
                                 f"expected {n} per chunk x {n_chunks}")
    steady = statistics.median(chunk_ms[1:])
    print(f"[main] {n_chunks} chunks of {T}x{H_HD}x{W_HD}: first "
          f"{chunk_ms[0]:.1f} ms, median of the rest {steady:.1f} ms "
          f"({T / steady * 1e3:.1f} frames/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, chunk_ms


def phase_profile(params, det_cfg) -> None:
    """One steady-state chunk of the dense stream under torch.profiler:
    host wall time, device busy time and share, kernel launches, and the
    device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.roundtrip import RoundtripConfig, roundtrip_chunk
    from repro_torch.sim.video_source import generate_chunk
    cfg = RoundtripConfig(level=LEVEL, det_cfg=det_cfg)
    raw, gtb, gtv = generate_chunk(_streams()[1], 3 * T, T)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        roundtrip_chunk(raw, gtb, gtv, params, tr1=TR1, tr2=TR2,
                        bw_kbps=6000.0, cfg=cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device-side events (kernels, copies, fills); the host ops that
    # launched them carry the same time and are left out
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    n = sum(r[1] for r in rows)
    print(f"[profile] one chunk {T}x{H_HD}x{W_HD}: wall {wall:.1f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), {n} device ops")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   {ms:8.3f} ms  {count:5d}x  {key[:90]}")


def phase_small_parity(params, det_cfg) -> None:
    """A 64x96 chunk through the kernels on the card against the port's
    plain path on the CPU (the contract of tests/test_torch_roundtrip.py)."""
    import torch
    from repro_torch.core.roundtrip import RoundtripConfig, roundtrip_chunk
    from repro_torch.sim.video_source import StreamConfig, generate_chunk
    raw, gtb, gtv = generate_chunk(
        StreamConfig(height=64, width=96, n_objects=3, seed=0), 0, 4,
        device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    for level in (2, 3):
        for tr1, tr2 in ((0.05, 0.1), (0.5, 0.02)):
            kw = dict(tr1=tr1, tr2=tr2, bw_kbps=6000.0,
                      cfg=RoundtripConfig(level=level, det_cfg=det_cfg))
            gpu = roundtrip_chunk(raw, gtb, gtv, params, **kw)
            cpu = roundtrip_chunk(raw, gtb, gtv, cpu_params, device="cpu",
                                  **kw)
            g = {k: v.cpu() for k, v in gpu.items()}
            if not torch.equal(g["types"], cpu["types"]) \
                    or not torch.equal(g["anchor_q"], cpu["anchor_q"]):
                raise AssertionError(f"small parity level {level}: types "
                                     f"{g['types'].tolist()} vs "
                                     f"{cpu['types'].tolist()}")
            for k, kwt in (("total_bits", dict(rtol=1e-4, atol=0)),
                           ("scores", dict(rtol=0, atol=1e-4)),
                           ("boxes", dict(rtol=0, atol=1e-2)),
                           ("latency", dict(rtol=1e-5, atol=0))):
                torch.testing.assert_close(g[k], cpu[k], **kwt)
            print(f"[parity] 64x96 T=4 level {level} tr=({tr1},{tr2}): card "
                  f"== CPU plain path (types {g['types'].tolist()})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.models.detection import TinyDetectorConfig, init

    card = phase_card()
    resolve_device()
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()

    g = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_motion_sad(g), *check_blockdct(g), check_qtransfer(g)]
    for k in kernels:
        print(f"[kernels] {k['name']} ({k['shape']}): {k['ms'] * 1e3:.1f} us,"
              f" plain {k['plain_ms'] * 1e3:.1f} us, bound "
              f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']})")

    det_cfg = TinyDetectorConfig()
    params = init(torch.Generator().manual_seed(1), det_cfg)
    launches, _ = phase_main_path(params, det_cfg)
    phase_profile(params, det_cfg)
    phase_small_parity(params, det_cfg)

    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
