"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> ...`` for any of the ten
``configs.ARCH_IDS`` (``--seq-len`` for the LMs, ``--img-res`` for the
vision and diffusion models).

Runs real training steps of the selected architecture: the step from
``build_cell``, a fresh ``materialize`` batch a step, the loop of
``train/loop.py`` with checkpoints and resume.  ``--reduced`` is on and
cannot be turned off, as in the reference (``store_true`` with
``default=True``; ROADMAP.md section 3).  Runs on CUDA unless ``device``
says otherwise.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ShapeCase, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_cell, materialize
from repro_torch.train import loop as LOOP


def main(argv=None, *, device=None) -> list:
    """Train ``--steps`` steps; prints each log point and returns the
    loop's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--img-res", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    arch = get_arch(args.arch, reduced=args.reduced)
    case = ShapeCase("cli_train", "train", batch=args.batch,
                     seq_len=args.seq_len, img_res=args.img_res)
    cell = build_cell(arch, case)
    generator = torch.Generator(device=dev).manual_seed(0)
    state, _ = materialize(generator, arch, case, dev)

    def gen():
        while True:
            yield materialize(generator, arch, case, dev)[1]

    cfg = LOOP.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=max(args.steps // 2, 1),
                          log_every=args.log_every)
    state, hist = LOOP.run(cell.fn, state, gen(), cfg,
                           on_metrics=lambda m: print(
                               {k: round(v, 4) for k, v in m.items()}))
    print(f"done: {len(hist)} log points; final loss "
          f"{hist[-1]['loss']:.4f}" if hist else "done")
    return hist


if __name__ == "__main__":
    main()
