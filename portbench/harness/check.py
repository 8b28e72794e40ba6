"""Whether what the timed path produced is correct: the sampled chunks'
outputs, read back by the window, against the plain reference computed
on the same inputs.

The numbers compared, each the worst over the sampled chunks:

* ``bits_gap``: the largest relative gap of a stream's video or anchor
  bits (the encode: its motion vectors, residuals and quantisation; the
  anchors and their chosen rungs);
* ``types_off``: frames whose Eq. 3 type or anchor quality differs;
* ``score_gap``: the largest gap of a cell's score after the detector,
  the ROI gate's scatter and carry, and reuse;
* ``box_gap``: the largest gap of a cell's box coordinate (px);
* ``f1_gap``: the largest gap of a frame's F1 (against the reference
  detector's HD detections, the inputs' target);
* ``nonfinite``: values of the program's outputs that are not finite.

Which of them a cell holds, and at what limit, is in its
``limits/<cell>.json``; a number with no limit there is printed and not
held.  A non-finite output makes its gap NaN, which fails every limit.

Besides, every run holds ``precision_off`` at 0: the convolution and
matmul TF32 switches that differ, once the window has closed, from the
configuration's stated ``detector.tf32``.
"""
from __future__ import annotations

import math

import torch

from harness import traffic as TR
from reference.roundtrip import roundtrip as reference

NUMBERS = ("bits_gap", "types_off", "score_gap", "box_gap", "f1_gap",
           "nonfinite")


def _gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare(got: dict, ref: dict) -> dict:
    """The numbers of one chunk: ``got`` the program's outputs, ``ref``
    the reference's, on one device."""
    rel = max(float(((got[k].double() - ref[k].double()).abs()
                     / ref[k].double().abs().clamp(min=1.0)).max())
              for k in ("video_bits", "anchor_bits"))
    off = (got["types"].long() != ref["types"].long()) \
        | (got["anchor_q"] != ref["anchor_q"])
    nonfinite = sum(int((~torch.isfinite(got[k])).sum())
                    for k in ("boxes", "scores", "f1", "video_bits",
                              "anchor_bits", "anchor_q"))
    return dict(bits_gap=rel, types_off=float(off.sum()),
                score_gap=_gap(got["scores"], ref["scores"]),
                box_gap=_gap(got["boxes"], ref["boxes"]),
                f1_gap=_gap(got["f1"], ref["f1"]), nonfinite=float(nonfinite))


def worst(readings: list) -> dict:
    """The worst of each number over chunks: the largest gap, the sum of
    the counts."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in readings]
        if any(math.isnan(v) for v in vals):
            out[k] = math.nan          # fails every limit
        else:
            out[k] = sum(vals) if k in ("types_off", "nonfinite") \
                else max(vals)
    return out


def reference_of(program, chunk_index: int, precision: str = "stated"):
    """The reference's outputs for chunk ``chunk_index`` of the program's
    inputs."""
    inputs, cfg = program.inputs, program.cfg
    raw, gtb, gtv = inputs.ring[inputs.slot(chunk_index)]
    return reference(raw, gtb, gtv, inputs.weights, cfg,
                     [int(r) for r in inputs.rungs[chunk_index]],
                     [float(b) for b in inputs.links[chunk_index]],
                     TR.LADDER, padded=program.padded, precision=precision)


def precision_off(cfg: dict) -> float:
    """How many of PyTorch's TF32 switches the program left other than
    the configuration states."""
    stated = bool(cfg["detector"]["tf32"])
    return float((torch.backends.cudnn.allow_tf32 != stated)
                 + (torch.backends.cuda.matmul.allow_tf32 != stated))


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(correct, lines): every held number within its limit; one line a
    number, ``name value limit``."""
    lines, ok = [], True
    for k in NUMBERS:
        if k not in limits:
            continue
        held = readings[k] <= limits[k]
        ok &= held
        lines.append((k, readings[k], limits[k], held))
    return ok, lines
