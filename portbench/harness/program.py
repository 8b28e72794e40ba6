"""The system under test as the benchmark drives it: the cameras' ring of
chunks and the detector's weights made on the device from the seed, and
one call of the port's round-trip entry a chunk.

Static configurations (``"ladder": "uniform"``) call
``repro_torch.core.roundtrip.roundtrip_batched`` with every stream at the
rung its share of the uplink allows; adaptive ones (``"per_stream"``) call
``roundtrip_padded_batched`` on the full LR canvas, each stream at the rung
of its share in that chunk: the cameras' LR frames, average-pooled from the
chunk's HD frames and laid onto the zero canvas as the chunk is submitted.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from harness import traffic as TR
from reference import decode as RD

f32 = torch.float32


def detector_weights(det: dict, seed: int, device) -> dict:
    """TinyDetector weights drawn on the device from the seed in one call:
    each conv weight ~ N(0, 1/cin) (OIHW), biases zero, float32."""
    shapes, cin = {}, 1
    for i, c in enumerate(det["channels"]):
        shapes[f"conv{i}"] = (c, cin, 3, 3)
        cin = c
    shapes["head"] = (5, cin, 1, 1)
    n = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed * TR.SEED_STRIDE + 7)
    flat = torch.randn(n, generator=g, dtype=f32, device=device)
    out, at = {}, 0
    for name, s in shapes.items():
        k = math.prod(s)
        out[name] = (flat[at:at + k] / math.sqrt(s[1])).reshape(s)
        at += k
        bias = "head_b" if name == "head" else name.replace("conv", "bias")
        out[bias] = torch.zeros(s[0], dtype=f32, device=device)
    return out


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed, for the program and the
    reference alike."""
    ring: list              # (raw (S, T, H, W), F1's target boxes, valid)
    links: np.ndarray       # (TRACE_STEPS, S) kbps, a row a chunk
    rungs: np.ndarray       # (TRACE_STEPS, S) the ladder's rung a chunk
    weights: dict

    def slot(self, i: int) -> int:
        return i % len(self.ring)


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                n_streams=None, frame_hw=None, chunk_frames=None) -> Inputs:
    """The ring of ``ring_chunks`` consecutive seconds of the
    configuration's cameras, rendered on the device, each camera's share
    of the uplink a chunk and the rung the ladder's rule gives it (static
    configurations: one rung for all, the lowest any share allows).

    F1's target in each frame is the reference detector's own output on
    the HD frame: its highest-scoring cells, as many as the densest
    camera has objects, those over the score threshold valid (BiSwift
    measures accuracy against detections on the original video; the
    rendered boxes would give F1 0 with random weights).  ``n_streams``,
    ``frame_hw`` and ``chunk_frames`` shrink the cell for tests on the
    CPU."""
    H, W = frame_hw or (cfg["height"], cfg["width"])
    T = chunk_frames or cfg["chunk_frames"]
    S = n_streams or cfg["streams"]
    if cfg.get("controller", "even") != "even":
        raise ValueError(f"no controller {cfg['controller']!r}: the "
                         "benchmark splits the uplink evenly")
    cams = TR.cameras(traffic["cameras"], S, H, W, seed)
    links = TR.links(traffic["uplink"], S, seed)
    rungs = np.vectorize(TR.rung_for_link)(links).astype(np.int64)
    if cfg["ladder"] == "uniform":
        rungs[:] = rungs.min()
    weights = detector_weights(cfg["detector"], seed, device)
    ring = []
    for k in range(traffic["ring_chunks"]):
        raw, boxes, _ = TR.render_chunk(cams, k * T, T, device)
        target, valid = RD.hd_detections(weights, cfg["detector"], raw,
                                         boxes.shape[2])
        ring.append((raw, target, valid))
    return Inputs(ring, links, rungs, weights)


OUTPUTS = ("boxes", "scores", "types", "anchor_q", "video_bits",
           "anchor_bits", "f1")


class Program:
    """The port's round trip over the benchmark's inputs: ``submit(i)``
    runs chunk i (ring slot i mod R, link row i) and returns the entry's
    outputs on the device."""

    def __init__(self, cfg: dict, inputs: Inputs, device=None):
        from repro_torch.codec.video_codec import VideoCodecConfig
        from repro_torch.core import roundtrip as RT
        from repro_torch.core.roi import RoiConfig
        from repro_torch.models.detection import TinyDetectorConfig
        self.RT = RT
        self.cfg = cfg
        self.inputs = inputs
        self.device = device
        dev = inputs.ring[0][0].device
        codec, det = cfg["codec"], cfg["detector"]
        self.rt_cfg = RT.RoundtripConfig(
            level=int(inputs.rungs[0, 0]),
            codec=VideoCodecConfig(search_radius=codec["search_radius"],
                                   gop=codec["gop"], dtype=codec["dtype"],
                                   search=codec["search"]),
            anchor_quality=cfg["anchor_quality"],
            det_cfg=TinyDetectorConfig(channels=tuple(det["channels"]),
                                       stride=det["stride"],
                                       dtype=det["dtype"]),
            fps=cfg["fps"], anchor_search=cfg["anchor_search"],
            roi=RoiConfig(**cfg["roi"]) if cfg.get("roi") else None)
        self.padded = cfg["ladder"] == "per_stream"
        # per-chunk scalars made once, so that a chunk copies nothing from
        # the host that the program did not ask for
        self.bw = torch.tensor(inputs.links, dtype=f32, device=dev)
        self.thresholds = {k: torch.full((1,), cfg[k], dtype=f32, device=dev)
                           for k in ("tr1", "tr2")}
        self.queue_delay = torch.zeros((1,), dtype=f32, device=dev)
        if self.padded:
            raw = inputs.ring[0][0]
            H, W = raw.shape[-2:]
            self.canvas = TR.lr_shape(len(TR.LADDER) - 1, H, W)
            self.extent = torch.tensor(
                [[TR.lr_shape(int(r), H, W) for r in row]
                 for row in inputs.rungs], dtype=torch.int32, device=dev)
            self.quality = torch.tensor(
                [[TR.LADDER[int(r)][2] for r in row] for row in inputs.rungs],
                dtype=f32)

    def lr_canvas(self, i: int):
        """The cameras' LR frames of chunk i, each at its rung, on the
        zero canvas."""
        raw = self.inputs.ring[self.inputs.slot(i)][0]
        S, T = raw.shape[:2]
        lr = torch.zeros((S, T, *self.canvas), dtype=f32, device=raw.device)
        for s in range(S):
            plane = TR.downscale(raw[s], int(self.inputs.rungs[i, s]))
            lr[s, :, :plane.shape[-2], :plane.shape[-1]] = plane
        return lr

    def submit(self, i: int) -> dict:
        raw, gtb, gtv = self.inputs.ring[self.inputs.slot(i)]
        kw = dict(tr1=self.thresholds["tr1"], tr2=self.thresholds["tr2"],
                  bw_kbps=self.bw[i], queue_delay=self.queue_delay,
                  cfg=self.rt_cfg, device=self.device)
        if self.padded:
            out = self.RT.roundtrip_padded_batched(
                raw, self.lr_canvas(i), self.extent[i],
                self.quality[i], gtb, gtv, self.inputs.weights, **kw)
        else:
            out = self.RT.roundtrip_batched(raw, gtb, gtv,
                                            self.inputs.weights, **kw)
        return {k: out[k] for k in OUTPUTS}
