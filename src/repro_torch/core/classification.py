"""Frame classification, Eq. 3 of the paper (port of
``repro.core.classification``).

  type 1 (anchor):   X_f > tr1            -> HD JPEG + full inference
  type 2 (transfer): X_f <= tr1, R_f > tr2 -> quality transfer + inference
  type 3 (reuse):    otherwise             -> MV-shift cached results

X_f and R_f accumulate since the last inference frame and reset at every
type-1/2 frame, so the classification is a sequential loop over frames.
"""
from __future__ import annotations

import numpy as np
import torch


def classify_frames(frame_diff, residual_mag, tr1, tr2):
    """frame_diff/residual_mag: (..., T) per-frame codec features
    (normalized); tr1/tr2: thresholds, one or one a lane of the leading
    axes (one a stream).

    Returns (types (..., T) int32 in {1,2,3}, X, R) on the inputs'
    device, X/R being the accumulated features compared against the
    thresholds.  The loop runs on the host in f32, as the reference's scan
    does, every lane at once: T is a chunk's frame count, and it costs one
    copy to the host.
    """
    dev = frame_diff.device
    return tuple(torch.from_numpy(a).to(dev)
                 for a in _classify_host(frame_diff, residual_mag, tr1, tr2))


def _classify_host(frame_diff, residual_mag, tr1, tr2):
    """:func:`classify_frames` with its results left on the host: (types,
    X, R) numpy arrays."""
    fd = frame_diff.detach().to("cpu", torch.float32).numpy()
    rm = residual_mag.detach().to("cpu", torch.float32).numpy()
    lead, T = fd.shape[:-1], fd.shape[-1]

    def per_lane(tr):
        tr = torch.as_tensor(tr).detach().to("cpu", torch.float32).numpy()
        return np.broadcast_to(tr, lead).astype(np.float32)

    tr1, tr2 = per_lane(tr1), per_lane(tr2)
    types = np.zeros(fd.shape, np.int32)
    X = np.zeros(fd.shape, np.float32)
    R = np.zeros(fd.shape, np.float32)
    acc_x = np.zeros(lead, np.float32)
    acc_r = np.zeros(lead, np.float32)
    for i in range(T):
        X[..., i] = acc_x + fd[..., i]
        R[..., i] = acc_r + rm[..., i]
        is1 = (X[..., i] > tr1) | (i == 0)   # the I-frame is an anchor
        is2 = ~is1 & (R[..., i] > tr2)
        types[..., i] = np.where(is1, 1, np.where(is2, 2, 3))
        inferred = types[..., i] != 3
        acc_x = np.where(inferred, np.float32(0.0), X[..., i])
        acc_r = np.where(inferred, np.float32(0.0), R[..., i])
    return types, X, R


def anchor_fraction(types):
    """The share of a chunk's frames that are anchors (type 1)."""
    return (types == 1).float().mean(-1)


def pipeline_fractions(types):
    """(..., 3) shares of a chunk's frames on pipelines 1, 2 and 3."""
    return torch.stack([(types == k).float().mean(-1) for k in (1, 2, 3)],
                       -1)
