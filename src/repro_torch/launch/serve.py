"""Serving launcher: the BiSwift multi-stream edge runtime (port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --streams 9 --height 720 --width 1280
--chunk-frames 30`` runs the whole loop on the card: synthetic cameras ->
hybrid encoder -> the (simulated) shared uplink -> the edge runtime (3
pipelines, batched detector, admission control) -> the bandwidth
controller's feedback.  The frames and every HD plane stay on the device;
each chunk's NMS and F1 run for all its frames in one batched call, with
one copy of the per-frame F1 to the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.bandwidth_controller import (BandwidthController,
                                                   even_proportions)
from repro_torch.core.hybrid_encoder import encode_hybrid
from repro_torch.device import host_to_device, resolve_device
from repro_torch.models import detection as D
from repro_torch.models.weights import (detector_params_from_jax,
                                        detector_params_to_jax)
from repro_torch.serving.runtime import EdgeRuntime
from repro_torch.serving.scheduler import ServingConfig
from repro_torch.sim.env import EnvConfig, MultiStreamEnv, high_state_dim
from repro_torch.sim.network import TraceConfig, allocate, generate_trace
from repro_torch.sim.video_source import generate_chunk, paper_stream_mix
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         init_state)

f32 = torch.float32


def fit_step(params: dict, opt: dict, det_cfg, ocfg: AdamWConfig, frames,
             boxes, valid):
    """One AdamW step on the detector's loss, the gradient by autograd
    through the plain detector.  Returns (params, opt, loss)."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = D.loss_fn(p, det_cfg, frames, boxes, valid)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    params, opt, _ = apply_updates(params, grads, opt, ocfg)
    return params, opt, loss.detach()


def quick_train(params: dict, det_cfg, streams, steps: int, *, device):
    """The launcher's inline detector fit: ``steps`` AdamW steps on
    4-frame chunks of the stream mix, in turns.  Returns (params, the
    last loss)."""
    opt = init_state(params)
    ocfg = AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=10,
                       total_steps=steps)
    loss = None
    for i in range(steps):
        fr, bx, vl = generate_chunk(streams[i % len(streams)], i * 4, 4,
                                    device=device)
        params, opt, loss = fit_step(params, opt, det_cfg, ocfg, fr, bx, vl)
    return params, loss


def restore_detector(ckpt_dir: str, like: dict, *, device) -> dict:
    """The detector of the latest checkpoint under ``ckpt_dir``, in the
    reference's layout on disk (``examples/train_detector.py``'s or
    ``repro_torch.launch.train_detector``'s), as the port's params on
    ``device``; ``like`` gives the names and shapes."""
    step = CKPT.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    tree = CKPT.restore(ckpt_dir, step, detector_params_to_jax(like))
    print(f"restored detector from {ckpt_dir} (step {step})")
    return detector_params_from_jax(tree, device)


def chunk_f1(boxes, scores, gt_boxes, gt_valid) -> np.ndarray:
    """(T,) F1 of a chunk's frames after NMS (IoU 0.4, top 16), all frames
    in one call on the ground truth's device; one copy to the host."""
    dev = gt_boxes.device
    nb, ns = D.greedy_nms(host_to_device(boxes, dev, f32),
                          host_to_device(scores, dev, f32), iou_thresh=0.4,
                          top_k=16)
    return D.f1_score(nb, ns, gt_boxes, gt_valid).cpu().numpy()


def main(argv=None, *, device=None) -> dict:
    """Serve ``--streams`` cameras for ``--chunks`` chunks; prints a line a
    chunk and stream and a summary, and returns the per-chunk F1 and
    latencies, the wall time and the frames/s.  Runs on CUDA unless
    ``device`` says otherwise."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--chunk-frames", type=int, default=4)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--bw-mean-kbps", type=float, default=16000.0)
    ap.add_argument("--controller", choices=["even", "sac"], default="even")
    ap.add_argument("--detector-ckpt", default=None)
    ap.add_argument("--quick-train", type=int, default=150,
                    help="inline detector fit steps when no ckpt (0=off)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    streams = paper_stream_mix(args.streams, args.height, args.width)
    det_cfg = D.TinyDetectorConfig()
    params = D.init(torch.Generator().manual_seed(1), det_cfg, device=dev)
    if args.detector_ckpt:
        params = restore_detector(args.detector_ckpt, params, device=dev)
    elif args.quick_train:
        print(f"quick-training detector ({args.quick_train} steps)...")
        params, loss = quick_train(params, det_cfg, streams,
                                   args.quick_train, device=dev)
        print(f"  final det loss {float(loss):.3f}")

    runtime = EdgeRuntime(ServingConfig(n_streams=args.streams), params,
                          det_cfg, device=dev)
    trace = generate_trace(TraceConfig(mean_kbps=args.bw_mean_kbps),
                           args.chunks)
    env_cfg = EnvConfig(streams=tuple(streams),
                        chunk_frames=args.chunk_frames)
    controller = None
    env = MultiStreamEnv(env_cfg, device=dev)
    if args.controller == "sac":
        controller = BandwidthController.create(
            torch.Generator().manual_seed(2), high_state_dim(env_cfg),
            args.streams, device=dev)

    f1_all, lat_all = [], []
    t_start = time.time()
    for t in range(args.chunks):
        env.t = t
        if controller is not None:
            # the deterministic action: no draw is read
            props = controller.proportions(
                torch.zeros(args.streams, device=dev), env.observe_high(),
                t, explore=False)
        else:
            props = even_proportions(args.streams)
        alloc = allocate(trace[t], props)
        for c, sc in enumerate(streams):
            frames, boxes, valid = generate_chunk(
                sc, t * args.chunk_frames, args.chunk_frames, device=dev)
            packet = encode_hybrid(frames, alloc[c], tr1=0.05, tr2=0.10,
                                   device=dev)
            b, s, types = runtime.process_chunk(c, t, packet)
            lat = runtime.compute_latency(types, packet.total_bits, alloc[c],
                                          stream=c)
            f1 = float(np.mean(chunk_f1(b, s, boxes,
                                        valid).astype(np.float64)))
            f1_all.append(f1)
            lat_all.append(lat["total"])
            print(f"chunk {t} stream {c}: bw={alloc[c]:7.0f}kbps "
                  f"types={types.tolist()} f1={f1:.3f} "
                  f"lat={lat['total'] * 1e3:6.1f}ms")
    wall = time.time() - t_start
    runtime.close()
    fps = args.streams * args.chunks * args.chunk_frames / wall
    print(f"\nmean F1 {np.mean(f1_all):.3f} | mean latency "
          f"{np.mean(lat_all) * 1e3:.1f} ms | deferred chunks "
          f"{runtime.deferred} | wall {wall:.1f}s ({fps:.1f} fps incl. "
          f"encode sim)")
    return {"f1": f1_all, "latency": lat_all, "wall_s": wall, "fps": fps,
            "deferred": runtime.deferred}


if __name__ == "__main__":
    main()
