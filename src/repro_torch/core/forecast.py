"""Per-stream bandwidth/content forecasting for predictive control (port
of ``repro.core.forecast``: the same numpy code, equal to it bit for bit).

The SAC bandwidth controller sees only the current chunk's statistics, so
it reallocates one controller interval after a demand spike or a link
collapse.  This small EWMA forecast head over per-stream rate and content
history extends the controller's state vector (``EnvConfig.forecast``:
``high_state_dim`` grows by ``forecast_dim(C)`` and
``MultiStreamEnv.observe_high`` appends ``features()``).

Everything here is float32 numpy with no randomness: the state after N
updates is a deterministic function of the observation sequence, and
``forecast=None`` (the default) leaves every path untouched.
"""
from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32

# features per stream: [ewma rate, rate dispersion, ewma demand, phase]
FEATURES_PER_STREAM = 4


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    """Hyper-parameters of the EWMA forecast head.

    ``alpha`` is the EWMA gain shared by the rate and demand trackers;
    ``period`` the chunk-count period of the periodic (diurnal-analogue)
    feature; ``rate_norm``/``bits_norm`` scale features to O(1) for the
    SAC state vector; ``floor_kbps`` bounds ``predict_bw`` away from
    zero so a post-outage prediction can never pin transmission off."""
    alpha: float = 0.4
    period: int = 8
    rate_norm: float = 5000.0
    bits_norm: float = 1e5
    floor_kbps: float = 1e-3


def forecast_dim(n_streams: int) -> int:
    """Width the forecast head adds to the high-level controller state."""
    return FEATURES_PER_STREAM * n_streams


class StreamForecaster:
    """EWMA rate/content tracker for C streams (deterministic, host-side).

    ``update`` folds one chunk's observations in; ``features`` exposes
    the normalized state for the controller; ``predict_bw`` is the
    serving-plane admission signal.  The EW variance uses the standard
    recurrence ``var' = (1 - a) * (var + a * delta^2)`` so dispersion is
    tracked without a second pass.  Prediction is the EWMA itself — NOT
    a lower confidence bound: subtracting k*std would keep the predicted
    rate pinned near zero for chunks after an outage (variance spikes
    exactly when the mean recovers), perpetuating holds and defeating
    recovery.
    """

    def __init__(self, cfg: ForecastConfig, n_streams: int):
        self.cfg = cfg
        self.n = int(n_streams)
        self.rate = np.zeros(self.n, f32)     # EWMA of observed kbps
        self.var = np.zeros(self.n, f32)      # EW variance of the rate
        self.demand = np.zeros(self.n, f32)   # EWMA of achieved bits/chunk
        self.t = 0
        self._warm = np.zeros(self.n, bool)   # has stream seen any obs?

    def update(self, bw_kbps, bits, mask=None) -> None:
        """Fold one chunk: bw_kbps (C,) observed rate, bits (C,) achieved
        transmission size (codec statistics the encoder already computed).
        ``mask`` (C,) bool marks streams that actually observed the link
        this chunk — unmasked streams keep their state untouched (a
        stalled camera learns nothing, and must not warm up on zeros)."""
        bw = np.asarray(bw_kbps, f32)
        bt = np.asarray(bits, f32)
        m = np.ones(self.n, bool) if mask is None else np.asarray(mask, bool)
        a = f32(self.cfg.alpha)
        first = ~self._warm
        delta = bw - self.rate
        new_rate = np.where(first, bw, self.rate + a * delta)
        new_var = np.where(first, f32(0.0),
                           (f32(1.0) - a) * (self.var + a * delta * delta))
        new_demand = np.where(first, bt,
                              self.demand + a * (bt - self.demand))
        self.rate = np.where(m, new_rate, self.rate).astype(f32)
        self.var = np.where(m, new_var, self.var).astype(f32)
        self.demand = np.where(m, new_demand, self.demand).astype(f32)
        self._warm = self._warm | (m & np.isfinite(bw))
        self.t += 1

    def predict_bw(self) -> np.ndarray:
        """(C,) predicted deliverable kbps for the NEXT chunk.  Cold
        streams predict +inf (no history — never hold on ignorance)."""
        floor = f32(self.cfg.floor_kbps)
        return np.where(self._warm, np.maximum(self.rate, floor),
                        np.inf).astype(f32)

    def features(self) -> np.ndarray:
        """(forecast_dim(C),) normalized state for the SAC controller:
        per-stream [rate, sqrt(var), demand] scaled to O(1) plus a shared
        periodic phase feature (the diurnal analogue at chunk scale)."""
        cfg = self.cfg
        phase = f32(np.sin(2.0 * np.pi * (self.t % cfg.period) / cfg.period))
        cols = np.stack([
            self.rate / f32(cfg.rate_norm),
            np.sqrt(self.var) / f32(cfg.rate_norm),
            self.demand / f32(cfg.bits_norm),
            np.full(self.n, phase, f32),
        ], axis=1)
        return cols.reshape(-1).astype(f32)

    def state(self) -> dict:
        """Copyable snapshot (replay-determinism assertions + reports)."""
        return {"rate": self.rate.copy(), "var": self.var.copy(),
                "demand": self.demand.copy(), "t": self.t,
                "warm": self._warm.copy()}
