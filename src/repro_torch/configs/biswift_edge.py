"""The paper's own system configuration (§VI-A/§VI-B) as a config file:
edge server budgets, codec ladder, pipeline costs, and DRL shapes (port
of ``repro.configs.biswift_edge``).

This is BiSwift's deployable edge profile, not one of the zoo's
architectures: ``build`` gives the env and serving configs of C streams.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hybrid_decoder import PipelineCosts
from repro_torch.models.detection import TinyDetectorConfig
from repro_torch.serving.scheduler import ServingConfig
from repro_torch.sim.env import EnvConfig
from repro_torch.sim.network import TraceConfig
from repro_torch.sim.video_source import paper_stream_mix


@dataclasses.dataclass(frozen=True)
class BiSwiftEdgeConfig:
    n_streams: int = 9                    # paper: 9 streams on one RTX-3070
    fps: float = 30.0
    chunk_seconds: float = 1.0
    controller_interval_s: float = 10.0   # bandwidth controller cadence
    latency_tau_s: float = 1.0            # Eq. 4 tolerance
    uplink_mbps: tuple = (8.0, 16.0)      # evaluated links (Fig. 13b)
    gpu_memory_gb: float = 8.0
    gpu_capacity_fps: float = 120.0
    costs: PipelineCosts = PipelineCosts()
    detector: TinyDetectorConfig = TinyDetectorConfig()
    # DRL shapes (§VI-B) live in repro_torch.rl.{a2c,sac} defaults:
    #   low: A2C 2x128, lr .005/.01, gamma .9, alpha1=alpha2=.5
    #   high: SAC 4x256 policy / 3x256 value+Q, lr .001/.003/.0003,
    #         tau .02, gamma .9, buffer 1e4, minibatch 128


def build(n_streams: int = 9, height: int = 96, width: int = 160):
    cfg = BiSwiftEdgeConfig(n_streams=n_streams)
    env = EnvConfig(
        streams=tuple(paper_stream_mix(n_streams, height, width)),
        chunk_frames=int(cfg.fps * cfg.chunk_seconds),
        fps=cfg.fps,
        trace=TraceConfig(mean_kbps=cfg.uplink_mbps[1] * 1000),
        gpu_capacity_fps=cfg.gpu_capacity_fps,
        latency_tau=cfg.latency_tau_s,
        controller_interval=int(cfg.controller_interval_s
                                / cfg.chunk_seconds),
    )
    serving = ServingConfig(
        n_streams=n_streams, gpu_capacity_fps=cfg.gpu_capacity_fps,
        latency_budget=cfg.latency_tau_s,
        controller_interval=env.controller_interval,
    )
    return cfg, env, serving
