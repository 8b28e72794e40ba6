"""The port's control-plane agents on the CPU: the MLPs, the
squashed-Gaussian helpers, AdamW, the A2C and SAC updates, the replay
buffers, the fairness head and the controller's proportions against the
JAX package, weights carried across with ``repro_torch.models.weights``;
and within the port, the stacked agents against the per-stream ones, bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandwidth_controller as JBC
from repro.core import fairness as JF
from repro.rl import a2c as JA
from repro.rl import networks as JN
from repro.rl import replay as JR
from repro.rl import sac as JS
from repro.train import optimizer as JO
from repro_torch.core import bandwidth_controller as BC
from repro_torch.core import fairness as F
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.weights import a2c_stack_from_jax, sac_agent_from_jax
from repro_torch.rl import a2c as A
from repro_torch.rl import networks as N
from repro_torch.rl import replay as R
from repro_torch.rl import sac as S
from repro_torch.train import optimizer as O

SDIM = 12
# f32 sums taken in another order than XLA's (the dense layers, the loss
# means, the norms): forward values within this of the reference's
FWD = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j_stack(C, seed=0):
    cfg = JA.A2CConfig(state_dim=SDIM)
    return cfg, JA.init_stacked(jax.random.split(jax.random.PRNGKey(seed), C),
                                cfg)


def _j_sac(C, seed=0):
    cfg = JS.SACConfig(state_dim=SDIM, action_dim=C, minibatch=16)
    return cfg, JS.init(jax.random.PRNGKey(seed), cfg)


def _a2c_batch(rng, lead, B=8):
    return {"states": rng.normal(size=lead + (B, SDIM)).astype(np.float32),
            "actions": rng.uniform(0.05, 0.95,
                                   size=lead + (B, 2)).astype(np.float32),
            "rewards": rng.normal(size=lead + (B,)).astype(np.float32),
            "next_states": rng.normal(size=lead + (B, SDIM))
            .astype(np.float32),
            "dones": (rng.uniform(size=lead + (B,)) < 0.2)
            .astype(np.float32)}


def _leaves_close(ours, ref, what, **tol):
    ours, ref = tree_leaves(ours), jax.tree.leaves(ref)
    assert len(ours) == len(ref), what
    for i, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol,
                                   err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------ networks
def test_weights_carry_across_with_optimizer_state():
    _, jstack = _j_stack(3)
    stack = a2c_stack_from_jax(_np(jstack), device="cpu")
    for o, r in zip(tree_leaves(stack), jax.tree.leaves(jstack)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert o.dtype == torch.from_numpy(np.array(r)).dtype
    assert stack["opt_a"]["step"].shape == (3,)
    _, jagent = _j_sac(3)
    agent = sac_agent_from_jax(_np(jagent), device="cpu")
    # the reference's value_target is the value net's very arrays; the
    # port's has storage of its own
    for k in agent["value"]:
        assert agent["value"][k].data_ptr() \
            != agent["value_target"][k].data_ptr()
        assert torch.equal(agent["value"][k], agent["value_target"][k])


@pytest.mark.parametrize("C", [1, 3, 8])
def test_low_heads_match_jax(C):
    """The stacked actor and critic heads of C agents (one state and a
    batch of states each) against the reference's vmapped heads."""
    _, jstack = _j_stack(C)
    stack = a2c_stack_from_jax(_np(jstack), device="cpu")
    rng = np.random.default_rng(C)
    for lead in ((C,), (C, 5)):
        x = rng.normal(size=lead + (SDIM,)).astype(np.float32)
        mu, ls = N.low_actor_apply(stack["actor"], _t(x))
        jmu, jls = jax.vmap(JN.low_actor_apply)(jstack["actor"],
                                                jnp.asarray(x))
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **FWD)
        np.testing.assert_allclose(ls.numpy(), np.asarray(jls), **FWD)
        v = N.low_critic_apply(stack["critic"], _t(x))
        jv = jax.vmap(JN.low_critic_apply)(jstack["critic"], jnp.asarray(x))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **FWD)
        mlp = N.mlp_apply(stack["critic"], _t(x), 2)
        jmlp = jax.vmap(lambda p, s: JN.mlp_apply(p, s, 2))(
            jstack["critic"], jnp.asarray(x))
        np.testing.assert_allclose(mlp.numpy(), np.asarray(jmlp), **FWD)


def test_high_heads_match_jax():
    C = 3
    _, jagent = _j_sac(C)
    agent = sac_agent_from_jax(_np(jagent), device="cpu")
    rng = np.random.default_rng(1)
    s = rng.normal(size=(16, SDIM)).astype(np.float32)
    a = rng.uniform(size=(16, C)).astype(np.float32)
    mu, ls = N.high_actor_apply(agent["actor"], _t(s))
    jmu, jls = JN.high_actor_apply(jagent["actor"], jnp.asarray(s))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **FWD)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), **FWD)
    np.testing.assert_allclose(
        N.high_value_apply(agent["value"], _t(s)).numpy(),
        np.asarray(JN.high_value_apply(jagent["value"], jnp.asarray(s))),
        **FWD)
    np.testing.assert_allclose(
        N.high_q_apply(agent["q1"], _t(s), _t(a)).numpy(),
        np.asarray(JN.high_q_apply(jagent["q1"], jnp.asarray(s),
                                   jnp.asarray(a))), **FWD)


def test_squashed_gaussian_matches_jax():
    """``eps`` drawn as the reference draws inside ``sample_squashed``:
    the action within 1e-6, the log-prob within 1e-5 relative (a sum of
    logs of 1 - tanh^2, steep where tanh saturates)."""
    rng = np.random.default_rng(2)
    mu = rng.normal(size=(16, 5)).astype(np.float32)
    log_std = rng.uniform(-3, 1, size=(16, 5)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, mu.shape, jnp.float32))
    ja, jlogp = JN.sample_squashed(key, jnp.asarray(mu), jnp.asarray(log_std))
    a, logp = N.sample_squashed(_t(eps), _t(mu), _t(log_std))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        N.deterministic_action(_t(mu)).numpy(),
        np.asarray(JN.deterministic_action(jnp.asarray(mu))), atol=1e-6)
    np.testing.assert_array_equal(
        N.policy_action(_t(eps), _t(mu), _t(log_std), False).numpy(),
        N.deterministic_action(_t(mu)).numpy())


# ----------------------------------------------------------- optimiser
@pytest.mark.parametrize("warmup", [0, 2])
def test_apply_updates_matches_jax(warmup):
    """Three AdamW steps (clipping on, weight decay on matrices) from the
    same parameters and gradients: lr, norm, moments and parameters
    within f32 rounding of the reference's (Adam's step is near sign(g)
    and the gradients here are far from 0, so no step flips)."""
    cfg = O.AdamWConfig(lr=0.01, warmup_steps=warmup, clip_norm=3.0)
    jcfg = JO.AdamWConfig(lr=0.01, warmup_steps=warmup, clip_norm=3.0)
    rng = np.random.default_rng(warmup)
    params = {"w0": rng.normal(size=(6, 4)).astype(np.float32),
              "b0": rng.normal(size=(4,)).astype(np.float32)}
    p, state = tree_map(_t, params), O.init_state(tree_map(_t, params))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JO.init_state(jp)
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) + 0.5).astype(np.float32)
             for k, v in params.items()}
        p, state, m = O.apply_updates(p, tree_map(_t, g), state, cfg)
        jp, jstate, jm = JO.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          jstate, jcfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6, err_msg=k)
        _leaves_close(p, jp, "params", rtol=0, atol=2e-7)
        # moments: f32 rounding of the clip scale, and cancellation in
        # b1 * mu + (1 - b1) * g on elements near 0
        _leaves_close(state["mu"], jstate["mu"], "mu", rtol=1e-5, atol=1e-8)
        _leaves_close(state["nu"], jstate["nu"], "nu", rtol=1e-5, atol=1e-8)
        assert int(state["step"]) == int(jstate["step"])


def test_stacked_norm_is_per_agent():
    """Agent 1's gradients are 1e4 times agent 0's: each is clipped by
    its own norm, so agent 0's step is its step alone."""
    cfg = O.AdamWConfig(lr=0.01, warmup_steps=0, clip_norm=1.0)
    rng = np.random.default_rng(4)
    w = _t(rng.normal(size=(2, 5, 3)))
    g = _t(rng.normal(size=(2, 5, 3)) * np.array([1.0, 1e4])[:, None, None])
    state = O.init_state({"w": w}, lead=(2,))
    new, _, m = O.apply_updates({"w": w}, {"w": g}, state, cfg)
    alone, _, m0 = O.apply_updates({"w": w[0]}, {"w": g[0]},
                                   O.init_state({"w": w[0]}), cfg)
    assert torch.equal(new["w"][0], alone["w"])
    assert torch.equal(m["grad_norm"][0], m0["grad_norm"])
    assert float(m["grad_norm"][1]) > 1e3 * float(m["grad_norm"][0])


# ------------------------------------------------------------- updates
def _flip_contract(ours, ref, grad_ref, lr: float, steps: int, what: str):
    """Parameters after ``steps`` Adam steps: within 1e-5 of the
    reference's, except on elements whose first gradient is near 0
    (|g| <= 1e-4 max|g| of its leaf), where rounding may flip a step's
    sign: there within 2 lr a step."""
    for i, (o, r, g) in enumerate(zip(tree_leaves(ours),
                                      jax.tree.leaves(ref),
                                      jax.tree.leaves(grad_ref))):
        o, r, g = o.numpy(), np.asarray(r), np.abs(np.asarray(g))
        near0 = g <= 1e-4 * max(float(g.max()), 1e-30)
        d = np.abs(o - r)
        assert (d[~near0] <= 1e-5).all(), (what, i, d[~near0].max())
        assert (d[near0] <= 2 * lr * steps + 1e-5).all(), (what, i)


@pytest.mark.parametrize("steps", [1, 3])
def test_a2c_update_matches_jax(steps):
    """The stacked A2C update of 3 agents against the reference's
    ``update_stacked``: first the gradients (Adam's first moment after
    one step is 0.1 x the clipped gradient: within 1e-4 of max|mu|),
    then the parameters under the sign-flip contract, the losses within
    1e-5."""
    C = 3
    cfg = A.A2CConfig(state_dim=SDIM)
    jcfg, jstack = _j_stack(C, seed=1)
    stack = a2c_stack_from_jax(_np(jstack), device="cpu")
    rng = np.random.default_rng(5)
    first_mu = None
    for step in range(steps):
        batch = _a2c_batch(rng, (C,))
        stack, logs = A.update_stacked(stack, tree_map(_t, batch), cfg)
        jstack, jlogs = JA.update_stacked(jstack, batch, jcfg)
        for k in logs:
            np.testing.assert_allclose(logs[k].numpy(), np.asarray(jlogs[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        if step == 0:
            first_mu = {"a": jstack["opt_a"]["mu"], "c": jstack["opt_c"]["mu"]}
            for ours, ref in ((stack["opt_a"]["mu"], jstack["opt_a"]["mu"]),
                              (stack["opt_c"]["mu"], jstack["opt_c"]["mu"])):
                for o, r in zip(tree_leaves(ours), jax.tree.leaves(ref)):
                    r = np.asarray(r)
                    np.testing.assert_allclose(
                        o.numpy(), r, rtol=0,
                        atol=1e-4 * float(np.abs(r).max()))
    _flip_contract(stack["actor"], jstack["actor"], first_mu["a"],
                   cfg.lr_actor, steps, "actor")
    _flip_contract(stack["critic"], jstack["critic"], first_mu["c"],
                   cfg.lr_critic, steps, "critic")


@pytest.mark.parametrize("steps", [1, 3])
def test_sac_update_matches_jax(steps):
    """SAC updates with the reference's noise (``eps`` from the keys its
    ``_update`` splits): gradients through Adam's first moment, then the
    four nets under the sign-flip contract, the target net within 1e-5,
    the losses within 1e-4 relative."""
    C = 3
    jcfg, jagent = _j_sac(C, seed=2)
    cfg = S.SACConfig(state_dim=SDIM, action_dim=C, minibatch=16)
    agent = sac_agent_from_jax(_np(jagent), device="cpu")
    rng = np.random.default_rng(6)
    first = None
    for step in range(steps):
        batch = {"states": rng.normal(size=(16, SDIM)).astype(np.float32),
                 "actions": rng.uniform(size=(16, C)).astype(np.float32),
                 "rewards": rng.normal(size=(16,)).astype(np.float32),
                 "next_states": rng.normal(size=(16, SDIM))
                 .astype(np.float32),
                 "dones": np.zeros((16,), np.float32)}
        key = jax.random.PRNGKey(100 + step)
        k1, k2 = jax.random.split(key)
        eps = tuple(_t(jax.random.normal(k, (16, C), jnp.float32))
                    for k in (k1, k2))
        agent, logs = S.update(eps, agent, tree_map(_t, batch), cfg)
        jagent, jlogs = JS.update(key, jagent, batch, jcfg)
        for k in logs:
            np.testing.assert_allclose(logs[k].numpy(), np.asarray(jlogs[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        if step == 0:
            first = {n: jagent[f"opt_{n}"]["mu"]
                     for n in ("actor", "value", "q1", "q2")}
            for n in first:
                for o, r in zip(tree_leaves(agent[f"opt_{n}"]["mu"]),
                                jax.tree.leaves(first[n])):
                    r = np.asarray(r)
                    np.testing.assert_allclose(
                        o.numpy(), r, rtol=0,
                        atol=1e-4 * float(np.abs(r).max()), err_msg=n)
    lrs = {"actor": cfg.lr_policy, "value": cfg.lr_value, "q1": cfg.lr_q,
           "q2": cfg.lr_q}
    for n, lr in lrs.items():
        _flip_contract(agent[n], jagent[n], first[n], lr, steps, n)
    _flip_contract(agent["value_target"], jagent["value_target"],
                   first["value"], cfg.lr_value * cfg.tau, steps,
                   "value_target")


def test_value_target_is_a_copy_that_tracks_tau():
    cfg = S.SACConfig(state_dim=SDIM, action_dim=2, minibatch=8)
    agent = S.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for k in agent["value"]:
        assert agent["value"][k].data_ptr() \
            != agent["value_target"][k].data_ptr()
    rng = np.random.default_rng(3)
    batch = {"states": _t(rng.normal(size=(8, SDIM))),
             "actions": _t(rng.uniform(size=(8, 2))),
             "rewards": _t(rng.normal(size=(8,))),
             "next_states": _t(rng.normal(size=(8, SDIM))),
             "dones": torch.zeros(8)}
    eps = (_t(rng.normal(size=(8, 2))), _t(rng.normal(size=(8, 2))))
    before = tree_map(torch.clone, agent["value_target"])
    new, _ = S.update(eps, agent, batch, cfg)
    for k in before:
        want = (1 - cfg.tau) * before[k] + cfg.tau * new["value"][k]
        assert torch.equal(new["value_target"][k], want)
        assert not torch.equal(new["value_target"][k], new["value"][k])
        assert new["value_target"][k].data_ptr() \
            != new["value"][k].data_ptr()
    # the agent passed in is left as it was
    for k in before:
        assert torch.equal(agent["value_target"][k], before[k])


# --------------------------------------------- stacked == per stream
@pytest.mark.parametrize("C", [1, 3, 8])
def test_stacked_act_update_bit_exact_vs_per_stream(C):
    """``act_stacked`` / ``update_stacked`` against C per-stream ``act`` /
    ``update`` calls on the sliced agents, bit for bit on the CPU; agent
    0's rewards are scaled by 1e3 so that its gradients clip and the
    others' do not."""
    cfg = A.A2CConfig(state_dim=SDIM)
    stack = A.init_stacked(torch.Generator().manual_seed(C), C, cfg, "cpu")
    assert A.n_stacked(stack) == C
    rng = np.random.default_rng(3)
    states = _t(rng.normal(size=(C, SDIM)))
    eps = _t(rng.normal(size=(C, 2)))
    for explore in (True, False):
        batched = A.act_stacked(eps, stack, states, explore)
        for c in range(C):
            one = A.act(eps[c], A.slice_agent(stack, c), states[c], explore)
            assert torch.equal(batched[c], one)
    batch = _a2c_batch(rng, (C,))
    batch["rewards"][0] *= 1e3
    batch = tree_map(_t, batch)
    for _ in range(2):
        new, logs = A.update_stacked(stack, batch, cfg)
        for c in range(C):
            want, wlog = A.update(A.slice_agent(stack, c),
                                  {k: v[c] for k, v in batch.items()}, cfg)
            for o, w in zip(tree_leaves(A.slice_agent(new, c)),
                            tree_leaves(want)):
                assert torch.equal(o, w)
            for k in wlog:
                assert torch.equal(logs[k][c], wlog[k]), k
        one = A.set_agent(stack, 0, A.slice_agent(new, 0))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(A.slice_agent(one, 0)),
            tree_leaves(A.slice_agent(new, 0))))
        stack = new


# ------------------------------------------------------ replay, fairness
@pytest.mark.parametrize("C", [1, 3])
def test_replay_sampling_equals_reference(C):
    cap = 16
    ours, ref = R.StackedReplayBuffer(cap, C, 3, 2), \
        JR.StackedReplayBuffer(cap, C, 3, 2)
    one, jone = R.ReplayBuffer(cap, 3, C), JR.ReplayBuffer(cap, 3, C)
    rng = np.random.default_rng(7)
    for t in range(40):                              # 40 > cap: wraps
        s = rng.normal(size=(C, 3)).astype(np.float32)
        a = rng.uniform(size=(C, 2)).astype(np.float32)
        r = rng.normal(size=C).astype(np.float32)
        s2 = rng.normal(size=(C, 3)).astype(np.float32)
        for buf in (ours, ref):
            buf.add_batch(s, a, r, s2, np.zeros(C))
        for buf in (one, jone):
            buf.add(s[0], a[:, 0], float(r[0]), s2[0], t % 7 == 0)
        if t in (5, 20, 39):
            for got, want in ((ours.sample(4), ref.sample(4)),
                              (ours.sample_stream(C - 1, 3),
                               ref.sample_stream(C - 1, 3)),
                              (one.sample(5), jone.sample(5))):
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], k)
    np.testing.assert_array_equal(ours.lens(), ref.lens())


def test_fairness_head_matches_jax():
    rng = np.random.default_rng(8)
    for n in (1, 3, 9):
        rewards = rng.normal(size=n).astype(np.float32)
        accs = rng.uniform(size=n).astype(np.float32)
        ours = F.fairness_head(_t(rewards), _t(accs))
        ref = JF.fairness_head(rewards, accs)
        for k in ref:
            np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                       rtol=1e-6, err_msg=k)
        assert float(F.jain_index(accs)) == pytest.approx(
            float(JF.jain_index(accs)), rel=1e-6)


@pytest.mark.parametrize("explore", [True, False])
def test_controller_proportions_match_jax(explore):
    """The controller's raw action and proportions from the same weights
    and noise, within 1e-6; then ``proportions`` caches them between
    reallocations as the reference's does."""
    C = 3
    jcfg, jagent = _j_sac(C, seed=3)
    agent = sac_agent_from_jax(_np(jagent), device="cpu")
    state = np.random.default_rng(9).normal(size=SDIM).astype(np.float32)
    key = jax.random.PRNGKey(11)
    eps = _t(jax.random.normal(key, (C,), jnp.float32))
    raw, props = BC.act_proportions(eps, agent, _t(state), explore)
    jraw, jprops = JBC.act_proportions(key, jagent, jnp.asarray(state),
                                       explore)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-6)
    np.testing.assert_allclose(props.numpy(), np.asarray(jprops), atol=1e-6)
    assert float(props.sum()) == pytest.approx(1.0, abs=1e-6)
    ctl = BC.BandwidthController(
        agent=agent, cfg=S.SACConfig(state_dim=SDIM, action_dim=C),
        buffer=R.ReplayBuffer(16, SDIM, C), interval=3)
    first = ctl.proportions(eps, state, 0, explore)
    np.testing.assert_array_equal(first, props.numpy())
    again = ctl.proportions(eps * 0 + 5.0, state, 1, explore)
    assert again is first                       # cached between intervals
    np.testing.assert_array_equal(BC.even_proportions(4),
                                  JBC.even_proportions(4))
