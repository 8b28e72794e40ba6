"""FCC-broadband-style bandwidth traces + shared-uplink simulation (port
of ``repro.sim.network``: the same numpy code, equal to it bit for bit).

The paper drives the total available bandwidth from an FCC trace (§VI-A)
and shapes per-camera links with WonderShaper.  Here: a stochastic trace
generator whose marginals mimic FCC fixed-broadband uplink measurements
(log-normal levels, AR(1) temporal correlation, occasional drops), a
shared-uplink splitter applying the controller's allocation vector, and
the chaos hook (:func:`apply_fault_profile`) that composes a fault
schedule's per-chunk multipliers onto a clean trace.

``generate_trace`` is vectorized (the AR(1) recurrence in blocked
cumulative form); ``generate_trace_loop`` keeps the step-by-step
recurrence as the reference implementation.  Both draw randomness
identically (one batched normal draw + one batched uniform draw), so they
agree to fp rounding of the recurrence itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    mean_kbps: float = 16000.0   # paper evaluates 8/16 Mbps uplinks
    std_log: float = 0.25
    ar: float = 0.9              # AR(1) coefficient
    drop_prob: float = 0.02      # transient dips
    drop_factor: float = 0.3
    floor_kbps: float = 1000.0
    seed: int = 0


def _draws(cfg: TraceConfig, n_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """The (normals, uniforms) both trace generators consume — drawn in
    one batch each so the vectorized and loop paths see identical
    randomness (a per-step ``rng.normal`` consumes a data-dependent number
    of raw draws, so interleaved ordering could never be replicated)."""
    rng = np.random.default_rng(cfg.seed)
    eps = rng.normal(0.0, cfg.std_log, n_steps)
    u = rng.random(n_steps)
    return eps, u


def _ar1_path(eps: np.ndarray, ar: float) -> np.ndarray:
    """x_t = ar·x_{t-1} + eps_t with x_{-1} = 0, vectorized.

    Blocked cumulative form: within a block of size B,
    ``x_{s+j} = ar^{j+1}·x_{s-1} + ar^j · cumsum(eps_{s+i} / ar^i)``.
    B is chosen so ``ar^{-(B-1)}`` stays comfortably inside float64 range
    (|ar| near 0 forces small blocks; |ar| near 1 allows thousands), which
    also keeps the reordered accumulation within fp rounding of the
    sequential recurrence: terms older than the representable dynamic
    range are exactly the ones the contraction has already damped away.
    """
    n = eps.size
    if n == 0:
        return eps.astype(np.float64)
    if not -1.0 < ar < 1.0:
        raise ValueError(f"AR(1) coefficient must satisfy |ar| < 1, got {ar}")
    if ar == 0.0:
        return eps.astype(np.float64)
    B = int(np.clip(-600.0 / np.log(abs(ar)), 1, 4096))
    out = np.empty(n, np.float64)
    carry = 0.0
    for s in range(0, n, B):
        e = eps[s:s + B].astype(np.float64)
        j = np.arange(e.size)
        p = ar ** j                               # ar^0 .. ar^(m-1)
        y = p * np.cumsum(e / p)                  # Σ_i ar^(j-i) eps_i
        blk = y + carry * ar * p                  # + ar^(j+1) x_{s-1}
        out[s:s + e.size] = blk
        carry = blk[-1]
    return out


def generate_trace(cfg: TraceConfig, n_steps: int) -> np.ndarray:
    """Per-chunk total available bandwidth (kbps), vectorized."""
    eps, u = _draws(cfg, n_steps)
    x = _ar1_path(eps * np.sqrt(1.0 - cfg.ar ** 2), cfg.ar)
    bw = cfg.mean_kbps * np.exp(x - cfg.std_log ** 2 / 2)
    bw = np.where(u < cfg.drop_prob, bw * cfg.drop_factor, bw)
    return np.maximum(bw, cfg.floor_kbps)


def generate_trace_loop(cfg: TraceConfig, n_steps: int) -> np.ndarray:
    """Step-by-step AR(1) reference (same draws as :func:`generate_trace`;
    agreement is fp-rounding-tight — the tolerance test's oracle)."""
    eps, u = _draws(cfg, n_steps)
    scale = np.sqrt(1.0 - cfg.ar ** 2)
    x = 0.0
    out = np.empty(n_steps, np.float64)
    for t in range(n_steps):
        x = cfg.ar * x + scale * eps[t]
        bw = cfg.mean_kbps * np.exp(x - cfg.std_log ** 2 / 2)
        if u[t] < cfg.drop_prob:
            bw *= cfg.drop_factor
        out[t] = max(bw, cfg.floor_kbps)
    return out


def apply_fault_profile(trace: np.ndarray, multipliers: np.ndarray,
                        floor_kbps: float = 1.0) -> np.ndarray:
    """Compose a chaos schedule's per-chunk bandwidth multipliers onto a
    clean trace (a fault schedule's ``bw_multiplier`` per chunk).

    An outage multiplier (≈0) deliberately punches BELOW the trace
    generator's ``floor_kbps`` — collapses are the whole point — but a
    1 kbps trickle remains so downstream latency models never divide by
    zero.
    """
    t = np.asarray(trace, np.float64)
    m = np.asarray(multipliers, np.float64)
    if t.shape != m.shape:
        raise ValueError(
            f"trace/multiplier length mismatch: {t.shape} vs {m.shape}")
    if np.any(m < 0.0):
        raise ValueError("bandwidth multipliers must be >= 0")
    return np.maximum(t * m, floor_kbps)


def allocate(total_kbps: float, proportions: np.ndarray) -> np.ndarray:
    """Split the shared uplink by the controller's proportion vector."""
    p = np.asarray(proportions, np.float64)
    p = np.maximum(p, 1e-6)
    p = p / p.sum()
    return total_kbps * p


def even_allocation(total_kbps: float, n_streams: int) -> np.ndarray:
    return np.full(n_streams, total_kbps / n_streams)
