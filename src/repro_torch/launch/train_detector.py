"""Train the detection DNN on synthetic surveillance streams, with
checkpoints (port of ``examples/train_detector.py``)::

    python -m repro_torch.launch.train_detector --steps 300

Two 64x96 streams in turns, 4-frame chunks, AdamW at lr 3e-3 with 20
warm-up steps; F1 on held-out frames every ``--eval-every`` steps, and a
checkpoint of the detector there in the reference's layout (HWIO, f32),
which ``launch/serve.py --detector-ckpt`` of either package serves.
Runs on CUDA unless ``device`` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.serve import fit_step
from repro_torch.models import detection as D
from repro_torch.models.weights import detector_params_to_jax
from repro_torch.sim.video_source import StreamConfig, generate_chunk
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import AdamWConfig, init_state

STREAMS = (
    StreamConfig(height=64, width=96, n_objects=2, min_size=16, max_size=28,
                 seed=7),
    StreamConfig(height=64, width=96, n_objects=5, min_size=12, max_size=20,
                 seed=8, speed=2.5),
)


def evaluate(params: dict, cfg: D.TinyDetectorConfig, streams, *,
             device) -> float:
    """Mean F1 over 4 held-out frames of each stream (from frame 50,000):
    NMS (IoU 0.4, top 16) and F1 batched over a chunk's frames, one copy
    to the host for all streams."""
    f1s = []
    with torch.no_grad():
        for sc in streams:
            frames, boxes, valid = generate_chunk(sc, 50_000, 4,
                                                  device=device)
            pb, ps = D.decode_boxes(D.forward(params, cfg, frames), cfg)
            nb, ns = D.greedy_nms(pb, ps, iou_thresh=0.4, top_k=16)
            f1s.append(D.f1_score(nb, ns, boxes, valid))
    return float(torch.cat(f1s).cpu().numpy().astype(np.float64).mean())


def main(argv=None, *, device=None) -> dict:
    """Train; returns the F1 at each evaluation and the steps on disk."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "biswift_detector"))
    ap.add_argument("--eval-every", type=int, default=100)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = D.TinyDetectorConfig()
    params = D.init(torch.Generator().manual_seed(0), cfg, device=dev)
    opt = init_state(params)
    ocfg = AdamWConfig(lr=3e-3, weight_decay=0.0, warmup_steps=20,
                       total_steps=args.steps)

    f1 = evaluate(params, cfg, STREAMS, device=dev)
    print(f"initial F1: {f1:.3f}")
    evals = []
    t0 = time.time()
    for i in range(args.steps):
        sc = STREAMS[i % len(STREAMS)]
        frames, boxes, valid = generate_chunk(sc, i * 4, 4, device=dev)
        params, opt, loss = fit_step(params, opt, cfg, ocfg, frames, boxes,
                                     valid)
        if (i + 1) % args.eval_every == 0:
            f1 = evaluate(params, cfg, STREAMS, device=dev)
            evals.append(f1)
            print(f"step {i + 1}: loss {float(loss):.4f}  F1 {f1:.3f}  "
                  f"({(i + 1) / (time.time() - t0):.1f} steps/s)")
            CKPT.save(args.ckpt_dir, i + 1, detector_params_to_jax(params))
    steps = CKPT.all_steps(args.ckpt_dir)
    print(f"checkpoints in {args.ckpt_dir}: steps {steps}")
    return {"f1": evals, "steps": steps, "params": params}


if __name__ == "__main__":
    main()
