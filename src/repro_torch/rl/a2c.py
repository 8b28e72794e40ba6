"""Low-level actor-critic agent, paper §V-A and §VI-B (port of
``repro.rl.a2c``).

A per-camera agent chooses the two classification thresholds (tr1, tr2)
of each chunk.  Hyper-parameters from the paper: Adam lr 0.005 (actor) /
0.01 (critic), discount 0.9, reward r = a1 * acc - a2 * latency penalty
with a1 = a2 = 0.5, tau = 1 s.

Stacked layout: the C agents of the bi-level control plane live in one
nested dict whose tensors carry a leading stream axis (``init_stacked``).
``act`` and ``update`` take one agent or such a stack: on a stack every
operation runs once for all C agents (``act_stacked`` and
``update_stacked`` name that use), and stream c's lane is computed as
agent c alone (``networks.dense``; per-agent reductions; per-agent
optimiser norms).  Gradients come from ``torch.autograd.grad`` on the
parameter tensors; nothing is updated in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.rl import networks as N
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    state_dim: int
    action_dim: int = 2
    lr_actor: float = 0.005
    lr_critic: float = 0.01
    gamma: float = 0.9
    alpha1: float = 0.5   # reward accuracy weight
    alpha2: float = 0.5   # reward latency-penalty weight
    tau_latency: float = 1.0
    entropy_coef: float = 1e-3


def reward(cfg: A2CConfig, mean_acc, latency):
    """Eq. 4: a1 * acc - a2 * P(latency > tau)."""
    penalty = (torch.as_tensor(latency) > cfg.tau_latency).to(f32)
    return cfg.alpha1 * torch.as_tensor(mean_acc, dtype=f32) \
        - cfg.alpha2 * penalty


def init(generator: torch.Generator, cfg: A2CConfig, device) -> dict:
    """One agent, drawn on the CPU from ``generator``, on ``device``."""
    actor = N.init_mlp(generator, N.low_actor_specs(cfg.state_dim,
                                                    cfg.action_dim), device)
    critic = N.init_mlp(generator, N.low_critic_specs(cfg.state_dim), device)
    return {"actor": actor, "critic": critic,
            "opt_a": init_state(actor), "opt_c": init_state(critic)}


def init_stacked(generator: torch.Generator, n_streams: int,
                 cfg: A2CConfig, device) -> dict:
    """C agents as one nested dict with a leading stream axis: agent c is
    the c-th ``init`` drawn from ``generator``."""
    agents = [init(generator, cfg, device) for _ in range(n_streams)]
    return tree_map(lambda *xs: torch.stack(xs), *agents)


def slice_agent(stacked, c: int) -> dict:
    """Agent ``c`` of a stack (views)."""
    return tree_map(lambda x: x[c], stacked)


def set_agent(stacked, c: int, agent) -> dict:
    """A copy of the stack with agent ``c`` replaced."""
    def put(s, a):
        s = s.clone()
        s[c] = a
        return s
    return tree_map(put, stacked, agent)


def n_stacked(stacked) -> int:
    return tree_leaves(stacked)[0].shape[0]


def act(eps, agent, state, explore: bool = True):
    """(..., action_dim) action in (0, 1): [tr1, tr2].  One agent and
    state (S,), or a stack and states (C, S); ``eps`` has the action's
    shape."""
    with torch.no_grad():
        mu, log_std = N.low_actor_apply(agent["actor"], state)
        return N.policy_action(eps, mu, log_std, explore)


# all C agents at once: (C, 2) draws, a stack, (C, S) states
act_stacked = act


def update(agent, batch, cfg: A2CConfig):
    """On-policy update over a batch of transitions: states (*C, B, S),
    actions (*C, B, A), rewards (*C, B), next_states (*C, B, S), dones
    (*C, B), the optional leading axis matching a stack.  Returns (new
    agent, logs), each log (*C,)."""
    s, a, r, s2, done = (batch["states"], batch["actions"],
                         batch["rewards"], batch["next_states"],
                         batch["dones"])
    with torch.no_grad():
        v2 = N.low_critic_apply(agent["critic"], s2)
        target = r + cfg.gamma * v2 * (1.0 - done)

    critic = N.leaf_params(agent["critic"])
    with torch.enable_grad():
        cl = (N.low_critic_apply(critic, s) - target).square().mean(-1)
        gc = N.grad(cl, critic)
    with torch.no_grad():
        adv = target - N.low_critic_apply(agent["critic"], s)
        # normalised advantages (population std, as jnp.std) and clipped
        # log-probs: the tanh-squash jacobian explodes near the bounds
        adv = (adv - adv.mean(-1, keepdim=True)) \
            / (adv.std(-1, correction=0, keepdim=True) + 1e-6)
        pre = N.f64(torch.atanh, (2 * a - 1).clamp(-0.995, 0.995))

    actor = N.leaf_params(agent["actor"])
    with torch.enable_grad():
        # REINFORCE on the pre-squash Gaussian: an unbiased estimator with
        # no tanh-density saturation attractor
        mu, log_std = N.low_actor_apply(actor, s)
        std = N.f64(torch.exp, log_std)
        logp = (-0.5 * ((pre - mu) / std).clamp(-6, 6).square()
                - log_std - N.HALF_LOG_2PI).sum(-1)
        ent = log_std.sum(-1).mean(-1)
        al = -(logp * adv).mean(-1) - cfg.entropy_coef * ent
        ga = N.grad(al, actor)

    oa = AdamWConfig(lr=cfg.lr_actor, weight_decay=0.0, warmup_steps=0,
                     clip_norm=5.0)
    oc = AdamWConfig(lr=cfg.lr_critic, weight_decay=0.0, warmup_steps=0,
                     clip_norm=5.0)
    new_actor, opt_a, _ = apply_updates(agent["actor"], ga, agent["opt_a"],
                                        oa)
    new_critic, opt_c, _ = apply_updates(agent["critic"], gc,
                                         agent["opt_c"], oc)
    return ({"actor": new_actor, "critic": new_critic,
             "opt_a": opt_a, "opt_c": opt_c},
            {"actor_loss": al.detach(), "critic_loss": cl.detach(),
             "mean_adv": adv.mean(-1)})


# all C agents from a (C, B, ...) batch stack at once
update_stacked = update
