"""Long float64 parity probes on the CPU, too long for the test suite: the
port's loops against the JAX package's on JAX's draws replayed, run for
far longer than the tests run them, reporting the first episode or slot
at which a quantity leaves its class and how far it has moved by the end.

    JAX_PLATFORMS=cpu python tests/torch_schedule_probes.py ps-dqn \
        --episodes 60
    JAX_PLATFORMS=cpu python tests/torch_schedule_probes.py ps-drqn \
        --episodes 360
    JAX_PLATFORMS=cpu python tests/torch_schedule_probes.py congested \
        --scale 50
    JAX_PLATFORMS=cpu python tests/torch_schedule_probes.py toy --scale 1

``ps-dqn`` / ``ps-drqn``: the loop of
tests/test_torch_ppo_ps_campaign.py::test_campaign_config_tracks_jax
(ps_campaign's config: the toy x 16 envs, batch 64, layers 256/256,
target_update 1000) for ``--episodes``; classes: the replay bit-equal,
the loss within 1e-12, the params within 1e-12.

``congested`` / ``toy``: configs/congested_6v_5r.yaml or toy_4ue_3r.yaml
with ``time_slots``, ``explore``, ``greedy`` and ``training_stop`` all
divided by ``--scale`` (the published ratios kept) and widths cut as
tests/test_torch_train_slice.py's ``_cut`` does; classes: actions and sum
rewards bit-equal, eps equal, the loss within 1e-10, the params within
1e-9.

Prints one JSON object; ``--out FILE`` also writes it there.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _first(found: dict, key: str, at) -> None:
    if key not in found:
        found[key] = at


def probe_ps(algo: str, episodes: int) -> dict:
    import test_torch_ps_slice as slice_test
    from diral_tpu.config import toy_4ue_3r
    from diral_tpu.train import ps_loop as jloop
    from diral_tpu_torch.scripts import ps_campaign
    from diral_tpu_torch.train import ps_loop as tloop

    slice_test.EPISODES = episodes
    jcfg = toy_4ue_3r(save_positions=False)
    jcfg = dataclasses.replace(
        jcfg, engine=dataclasses.replace(jcfg.engine, num_envs=16),
        agent=dataclasses.replace(jcfg.agent, batch_size=64,
                                  target_update=1000))
    tcfg = ps_campaign.ps_config(16)
    init_fn, episode_fn, _ = jloop.make_ps_functions(jcfg, algo, jnp.float64)
    jcarry = jax.jit(init_fn)(jax.random.PRNGKey(slice_test.SEED))
    episode = jax.jit(episode_fn)
    fns = tloop.make_ps_functions(tcfg, algo, torch.float64, device="cpu")
    draws = slice_test.JaxPSDraws(jcfg, fns.n_batches)
    carry = fns.init_carry(draws, learner=slice_test._convert(
        algo, jcarry.learner, tcfg.agent))
    found, worst, trace = {}, {"loss": 0.0, "params": 0.0}, []
    for ep in range(episodes):
        jcarry, jlog = episode(jcarry, jnp.asarray(ep, jnp.int32))
        carry, log = fns.episode(carry, ep, draws)
        for k in ("states", "actions", "rewards"):
            if not np.array_equal(getattr(carry.replay, k).numpy(),
                                  np.asarray(getattr(jcarry.replay, k))):
                _first(found, f"replay {k}", ep)
        if log["eps"] != np.float32(jlog["eps"]):
            _first(found, "eps", ep)
        dl = abs(float(log["loss"]) - float(jlog["loss"]))
        want = slice_test.learner_dict(jcarry.learner)
        dp = 0.0
        for net, key in ((carry.learner.params, "params"),
                         (carry.learner.target_params, "target_params")):
            for name, p in net.named_parameters():
                g, k = name.split(".")
                dp = max(dp, float(np.abs(p.detach().numpy()
                                          - want[key][g][k]).max()))
        worst = {"loss": max(worst["loss"], dl),
                 "params": max(worst["params"], dp)}
        if dl > 1e-12:
            _first(found, "loss", ep)
        if dp > 1e-12:
            _first(found, "params", ep)
        if ep % 20 == 19 or ep == episodes - 1:
            trace.append({"episode": ep, "loss_diff": dl, "param_diff": dp})
    return {"probe": algo, "episodes": episodes,
            "n_batches": fns.n_batches,
            "target_update": tcfg.agent.target_update,
            "first_out_of_class": found, "worst": worst, "trace": trace}


CONFIGS = {"congested": "congested_6v_5r.yaml", "toy": "toy_4ue_3r.yaml"}


def probe_drqn(name: str, scale: int) -> dict:
    from test_torch_train_slice import FIELDS, JaxChainDraws, _cut, carry_dict
    from diral_tpu.config import load_config as jload
    from diral_tpu.train import loop as jloop
    from diral_tpu_torch.config import load_config as tload
    from diral_tpu_torch.convert import train_carry_from_numpy
    from diral_tpu_torch.train import loop as tloop

    path = os.path.join(os.path.dirname(HERE), "configs", CONFIGS[name])

    def scaled(cfg):
        return dataclasses.replace(
            _cut(cfg), time_slots=cfg.time_slots // scale,
            explore=cfg.explore // scale, greedy=cfg.greedy // scale,
            training_stop=cfg.training_stop // scale)

    jcfg, tcfg = scaled(jload(path)), scaled(tload(path))
    slots, seed = jcfg.time_slots, 7
    init_fn, slot_step, _ = jloop.make_train_functions(jcfg, jnp.float64)
    jcarry = jax.jit(init_fn)(jax.random.PRNGKey(seed))
    step = jax.jit(slot_step)
    d0 = carry_dict(jcarry)
    fns = tloop.make_train_functions(tcfg, torch.float64, "cpu")
    carry = train_carry_from_numpy(d0, tcfg)
    draws = JaxChainDraws(jcarry.key, jcfg, seed, slots,
                          params=d0["learner"]["params"])
    found, worst, trace, n_train = {}, {"loss": 0.0, "params": 0.0}, [], 0
    for t in range(slots):
        jcarry, jlg = step(jcarry, jnp.asarray(t, jnp.int32))
        carry, lg = fns.slot_step(carry, t, draws)
        if not np.array_equal(lg["actions"].numpy(), np.asarray(
                jlg["actions"])):
            _first(found, "actions", t)
        if not np.array_equal(lg["sum_reward"].numpy(), np.asarray(
                jlg["sum_reward"])):
            _first(found, "sum_reward", t)
        if lg["eps"] != np.float32(jlg["eps"]):
            _first(found, "eps", t)
        loss = 0.0 if lg["loss"] is None else float(lg["loss"])
        n_train += lg["loss"] is not None
        dl = abs(loss - float(jlg["loss"]))
        worst["loss"] = max(worst["loss"], dl)
        if dl > 1e-10:
            _first(found, "loss", t)
        if lg["loss"] is not None or t == slots - 1:
            got = carry.learner.params.tree()
            dp = max(float(np.abs(got[g][k].detach().numpy()
                                  - np.asarray(v)).max())
                     for g, leaves in jcarry.learner.params.items()
                     for k, v in leaves.items())
            worst["params"] = max(worst["params"], dp)
            if dp > 1e-9:
                _first(found, "params", t)
        if t % 250 == 249 or t in (jcfg.explore, jcfg.greedy,
                                   jcfg.greedy + 50) or t == slots - 1:
            trace.append({"slot": t, "loss_diff": dl,
                          "param_diff": worst["params"],
                          "eps": float(lg["eps"])})
    ring = np.array_equal(carry.replay.buf.numpy(),
                          np.asarray(jcarry.replay.buf))
    env = all(np.array_equal(getattr(carry.env_state, f).numpy(),
                             np.asarray(getattr(jcarry.env_state, f)))
              for f in FIELDS)
    return {"probe": name, "scale": scale, "slots": slots,
            "explore": jcfg.explore, "greedy": jcfg.greedy,
            "training_stop": jcfg.training_stop, "train_events": n_train,
            "first_out_of_class": found, "worst": worst,
            "final_ring_equal": ring, "final_env_equal": env,
            "trace": trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("ps-dqn", "ps-drqn", *CONFIGS))
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--scale", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    t0 = time.time()
    if args.probe in CONFIGS:
        res = probe_drqn(args.probe, args.scale)
    else:
        res = probe_ps(args.probe, args.episodes)
    res["seconds"] = round(time.time() - t0, 1)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
