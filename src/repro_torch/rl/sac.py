"""High-level Soft Actor-Critic bandwidth controller, paper §V-B and §VI-B
(port of ``repro.rl.sac``).

Hyper-parameters from the paper: policy lr 0.001, value lr 0.003, Q lr
0.0003; target update tau 0.02; gamma 0.9; replay 1e4; minibatch 128.
Policy a 4x256 MLP, value and Q 3x256 MLPs.  The action is the per-stream
bandwidth proportion vector (normalised downstream).  The update's two
squashed-Gaussian samples take their standard normal draws as tensors,
``eps``, each (minibatch, C).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_map
from repro_torch.rl import networks as N
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SACConfig:
    state_dim: int
    action_dim: int
    lr_policy: float = 0.001
    lr_value: float = 0.003
    lr_q: float = 0.0003
    tau: float = 0.02
    gamma: float = 0.9
    alpha: float = 0.05          # entropy temperature
    buffer_size: int = 10_000
    minibatch: int = 128


def init(generator: torch.Generator, cfg: SACConfig, device) -> dict:
    """Drawn on the CPU from ``generator``, on ``device``.  The value
    target starts as a copy of the value net, never the same tensors."""
    actor = N.init_mlp(generator, N.high_actor_specs(cfg.state_dim,
                                                     cfg.action_dim), device)
    value = N.init_mlp(generator, N.high_value_specs(cfg.state_dim), device)
    q1 = N.init_mlp(generator, N.high_q_specs(cfg.state_dim, cfg.action_dim),
                    device)
    q2 = N.init_mlp(generator, N.high_q_specs(cfg.state_dim, cfg.action_dim),
                    device)
    return {"actor": actor, "value": value,
            "value_target": tree_map(torch.clone, value),
            "q1": q1, "q2": q2,
            "opt_actor": init_state(actor), "opt_value": init_state(value),
            "opt_q1": init_state(q1), "opt_q2": init_state(q2)}


def act(eps, agent, state, explore: bool = True):
    """(C,) action in (0, 1); normalised to proportions by the caller."""
    with torch.no_grad():
        mu, log_std = N.high_actor_apply(agent["actor"], state)
        return N.policy_action(eps, mu, log_std, explore)


def update(eps, agent, batch, cfg: SACConfig):
    """One SAC update from a minibatch; ``eps`` is the pair of (minibatch,
    C) draws of the value target's and the policy's samples.  Returns (new
    agent, logs); nothing is written in place."""
    eps1, eps2 = eps
    s, a, r, s2, done = (batch["states"], batch["actions"],
                         batch["rewards"], batch["next_states"],
                         batch["dones"])

    # --- Q update: target r + gamma V_target(s') -----------------------
    with torch.no_grad():
        vt = N.high_value_apply(agent["value_target"], s2)
        q_target = r + cfg.gamma * vt * (1 - done)

    def q_step(params):
        params = N.leaf_params(params)
        with torch.enable_grad():
            loss = (N.high_q_apply(params, s, a) - q_target).square().mean()
            return loss.detach(), N.grad(loss, params)

    ql1, gq1 = q_step(agent["q1"])
    ql2, gq2 = q_step(agent["q2"])

    # --- value update: target E[min Q(s, a~pi) - alpha log pi] ---------
    with torch.no_grad():
        mu, log_std = N.high_actor_apply(agent["actor"], s)
        a_new, logp = N.sample_squashed(eps1, mu, log_std)
        qmin = torch.minimum(N.high_q_apply(agent["q1"], s, a_new),
                             N.high_q_apply(agent["q2"], s, a_new))
        v_target = qmin - cfg.alpha * logp
    value = N.leaf_params(agent["value"])
    with torch.enable_grad():
        vl = (N.high_value_apply(value, s) - v_target).square().mean()
        gv = N.grad(vl, value)

    # --- policy update (through the Q nets, whose weights stay put) ----
    actor = N.leaf_params(agent["actor"])
    with torch.enable_grad():
        mu, log_std = N.high_actor_apply(actor, s)
        a_s, logp_s = N.sample_squashed(eps2, mu, log_std)
        q = torch.minimum(N.high_q_apply(agent["q1"], s, a_s),
                          N.high_q_apply(agent["q2"], s, a_s))
        pl = (cfg.alpha * logp_s - q).mean()
        gp = N.grad(pl, actor)

    oq = AdamWConfig(lr=cfg.lr_q, weight_decay=0.0, warmup_steps=0,
                     clip_norm=5.0)
    ov = AdamWConfig(lr=cfg.lr_value, weight_decay=0.0, warmup_steps=0,
                     clip_norm=5.0)
    op = AdamWConfig(lr=cfg.lr_policy, weight_decay=0.0, warmup_steps=0,
                     clip_norm=5.0)
    q1, oq1, _ = apply_updates(agent["q1"], gq1, agent["opt_q1"], oq)
    q2, oq2, _ = apply_updates(agent["q2"], gq2, agent["opt_q2"], oq)
    value, ov_, _ = apply_updates(agent["value"], gv, agent["opt_value"], ov)
    actor, oa_, _ = apply_updates(agent["actor"], gp, agent["opt_actor"], op)
    with torch.no_grad():
        target = tree_map(lambda t, o: (1 - cfg.tau) * t + cfg.tau * o,
                          agent["value_target"], value)
    new_agent = {"actor": actor, "value": value, "value_target": target,
                 "q1": q1, "q2": q2, "opt_actor": oa_, "opt_value": ov_,
                 "opt_q1": oq1, "opt_q2": oq2}
    return new_agent, {"q_loss": 0.5 * (ql1 + ql2), "v_loss": vl.detach(),
                       "pi_loss": pl.detach()}
