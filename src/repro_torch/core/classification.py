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
    """frame_diff/residual_mag: (T,) per-frame codec features (normalized).

    Returns (types (T,) int32 in {1,2,3}, X (T,), R (T,)) on the inputs'
    device, X/R being the accumulated features compared against the
    thresholds.  The loop runs on the host in f32, as the reference's scan
    does: T is a chunk's frame count, and it costs one copy to the host.
    """
    fd = frame_diff.detach().to("cpu", torch.float32).numpy()
    rm = residual_mag.detach().to("cpu", torch.float32).numpy()
    tr1, tr2 = np.float32(tr1), np.float32(tr2)
    T = fd.shape[0]
    types = np.zeros(T, np.int32)
    X = np.zeros(T, np.float32)
    R = np.zeros(T, np.float32)
    acc_x = acc_r = np.float32(0.0)
    for i in range(T):
        X[i] = acc_x + fd[i]
        R[i] = acc_r + rm[i]
        is1 = X[i] > tr1 or i == 0      # chunk I-frame is always an anchor
        is2 = not is1 and R[i] > tr2
        types[i] = 1 if is1 else (2 if is2 else 3)
        inferred = types[i] != 3
        acc_x = np.float32(0.0) if inferred else X[i]
        acc_r = np.float32(0.0) if inferred else R[i]
    dev = frame_diff.device
    return (torch.from_numpy(types).to(dev), torch.from_numpy(X).to(dev),
            torch.from_numpy(R).to(dev))
