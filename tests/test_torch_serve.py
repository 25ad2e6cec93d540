"""Online serving on the port (diral_tpu_torch/interop/serve.py) against
the JAX package's (diral_tpu/interop/serve.py), on the CPU.

* The serving loops held against JAX's on one simulator seed: JAX's loop
  serves the JAX-built simulator and a recording gateway logs every
  action it grants; the port's loop serves the port's simulator with
  draws injected so that every action is the recorded one (eps 1.0, draw
  0, the random action = the recorded one).  The stream the port receives
  (SN, state, reward), every flush's replay contents and the stats must
  be bit-equal to JAX's: ``serve_and_learn`` in dist mode (PS-DRQN,
  episode replay) and ``serve_and_learn_dqn`` in syn mode (PS-DQN,
  transition replay).  ``serve_sps`` replays JAX's key chain through its
  draws and must grant JAX's actions and see JAX's RSSI windows.
* ``SNAlignedEpisodes`` against JAX's under shuffled, duplicated and lost
  rewards: the replay after every flush and the slot flags bit-equal.
* Counterparts of tests/test_serve.py, run on the port.
* The ``serve`` verb in each of its five modes on the CPU, and its refusal
  without a GPU.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diral_tpu import config as jconfig
from diral_tpu.agents import dqn as jdqn
from diral_tpu.agents import ps_drqn as jps
from diral_tpu.agents.replay import TransitionReplay as JTransitionReplay
from diral_tpu.interop import gateway_env as jgw
from diral_tpu.interop import serve as jserve
from diral_tpu_torch import config as tconfig
from diral_tpu_torch.agents import dqn as tdqn
from diral_tpu_torch.agents import ps_drqn as tps
from diral_tpu_torch.agents.replay import TransitionReplay
from diral_tpu_torch.interop import gateway_env as tgw
from diral_tpu_torch.interop import serve as tserve
from diral_tpu_torch.train import cli

from test_torch_interop import jax_sim_binary, needs_jax_sim

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _cfg(module, **net):
    """The toy agent cut as tests/test_serve.py cuts it."""
    cfg = module.toy_4ue_3r().agent
    kw = dict(batch_size=4, unroll_step=4, target_update=8)
    network = dict(use_lstm_input=False, use_dueling=False, layers=(16, 16))
    if net.pop("dqn", False):
        kw = dict(batch_size=8, target_update=4)
        network["use_dueling"] = True
    return dataclasses.replace(
        cfg, **kw, network=dataclasses.replace(cfg.network, **network))


def _finish(env):
    env.bridge.restart_env()
    env.sim_process.wait(timeout=10)
    env.sim_process = None


# -- recording seams ----------------------------------------------------------

def _recording(base):
    class Recording(base):
        """Logs what each request brings and each grant sends."""

        def __init__(self, **kw):
            self.stream, self.actions = [], []
            super().__init__(**kw)

        def get_observation_syn_dist(self):
            out = super().get_observation_syn_dist()
            self.stream.append(out)
            return out

        def get_observation_syn(self):
            out = super().get_observation_syn()
            self.stream.append(out)
            return out

        def get_observation_syn_sps(self):
            out = super().get_observation_syn_sps()
            self.stream.append(out)
            return out

        def apply_action(self, action):
            self.actions.append(int(action))
            super().apply_action(action)

    return Recording


JaxRecordingEnv = _recording(jgw.GatewayEnv)
PortRecordingEnv = _recording(tgw.GatewayEnv)

_FIELDS = ("states", "actions", "rewards", "terminals", "lengths", "masks",
           "ptr", "head", "count")


def _snapshot(replay) -> dict:
    out = {}
    for k in _FIELDS:
        if not hasattr(replay, k):
            continue
        v = getattr(replay, k)
        # a copy: the port's replay is updated in place
        out[k] = (v.cpu().numpy().copy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
        if out[k].ndim == 0:
            out[k] = int(out[k])
    return out


def _recording_episodes(base, log):
    class Recording(base):
        def flush(self, replay, sink=None):
            replay = super().flush(replay, sink)
            log.append(_snapshot(replay))
            return replay

    return Recording


def _assert_same_snapshots(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], int):
                assert a[k] == b[k], k
            else:
                assert a[k].dtype == b[k].dtype, k
                assert a[k].tobytes() == b[k].tobytes(), k


def _assert_same_stream(ours, theirs):
    assert len(ours) == len(theirs) and ours
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            else:
                assert type(x) is type(y) and x == y


class ForcedActions(tserve.ServeDraws):
    """Every eps-greedy draw is (0, the next recorded action): with eps
    1.0 the loop grants exactly the recorded actions."""

    def __init__(self, actions):
        super().__init__(torch.Generator().manual_seed(0))
        self.queue = list(actions)

    def eps_greedy(self, ep, i, rows, num_actions):
        assert rows == 1
        return torch.zeros(1), torch.tensor([self.queue.pop(0)])


_STATS = ("rounds", "mean_reward", "mean_prr", "mean_prr_tail",
          "train_calls")


def _serve_pair(monkeypatch, jax_loop, port_loop, sim_kw, loop_kw):
    """Run JAX's loop on the JAX sim, then the port's on the port's sim with
    JAX's actions forced.  Returns (jax env, port env, jax stats, port
    stats, jax flushes, port flushes)."""
    monkeypatch.setattr(jgw, "build_simulator", jax_sim_binary)
    jflush, tflush = [], []
    monkeypatch.setattr(jserve, "SNAlignedEpisodes",
                        _recording_episodes(jserve.SNAlignedEpisodes, jflush))
    monkeypatch.setattr(tserve, "SNAlignedEpisodes",
                        _recording_episodes(tserve.SNAlignedEpisodes, tflush))
    jenv = JaxRecordingEnv(port=0, sim_start=True, **sim_kw)
    try:
        _, jstats = jax_loop(jenv, **loop_kw)
        _finish(jenv)
    finally:
        jenv.close()
    tenv = PortRecordingEnv(port=0, sim_start=True, **sim_kw)
    try:
        _, tstats = port_loop(tenv, draws=ForcedActions(jenv.actions))
        _finish(tenv)
    finally:
        tenv.close()
    assert tenv.actions == jenv.actions
    _assert_same_stream(tenv.stream, jenv.stream)
    _assert_same_snapshots(tflush, jflush)
    assert {k: tstats[k] for k in _STATS} == {k: jstats[k] for k in _STATS}
    return jstats, tstats


@needs_jax_sim
def test_serve_and_learn_dist_bit_equal_jax(monkeypatch):
    """PS-DRQN, dist mode, reward design 2, 60 rounds of 4 users, a flush
    and train call every 15 rounds."""
    sim_kw = dict(sim_users=4, sim_channels=3, sim_rounds=65, sim_seed=3,
                  state_design=2, pos_dist=2, state_bins=10, state_range=250,
                  reward_design=2)
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jstats, tstats = _serve_pair(
        monkeypatch,
        lambda env, **kw: jserve.serve_and_learn(env, jcfg, **kw),
        lambda env, draws: tserve.serve_and_learn(
            env, tcfg, 60, train_every=15, n_batches=2, eps=1.0,
            device="cpu", draws=draws),
        sim_kw, dict(rounds=60, train_every=15, n_batches=2, eps=0.3))
    assert tstats["train_calls"] == 4
    assert np.isfinite(tstats["losses"]).all()


@needs_jax_sim
def test_serve_and_learn_dqn_syn_bit_equal_jax(monkeypatch):
    """PS-DQN, syn (RSSI) mode, 60 rounds of 4 users, a flush every 15
    rounds into the transition replay."""
    sim_kw = dict(sim_users=4, sim_channels=3, sim_rounds=65, sim_seed=11,
                  sim_mode="syn")
    jcfg, tcfg = _cfg(jconfig, dqn=True), _cfg(tconfig, dqn=True)
    jstats, tstats = _serve_pair(
        monkeypatch,
        lambda env, **kw: jserve.serve_and_learn_dqn(env, jcfg, **kw),
        lambda env, draws: tserve.serve_and_learn_dqn(
            env, tcfg, 60, train_every=15, n_batches=2, eps=1.0,
            device="cpu", draws=draws),
        sim_kw, dict(rounds=60, train_every=15, n_batches=2, eps=0.5,
                     eps_final=0.05))
    assert tstats["train_calls"] == 4
    assert np.isfinite(tstats["losses"]).all()


class JaxSPSDraws(tserve.ServeDraws):
    """SPS's draws from JAX's key chain in serve_sps: the initial state
    from ``sps_init(k0)``, per request the counter and keep draws of
    ``sps_step(ka)``.  The pick is free: with 3 channels the shortlist
    holds one resource."""

    def __init__(self, seed):
        super().__init__(torch.Generator().manual_seed(0))
        self.key, self.k0 = jax.random.split(jax.random.PRNGKey(seed))

    def sps_init(self, n, c):
        from diral_tpu.agents import sps as jsps
        from diral_tpu_torch.agents import sps as tsps

        s = jsps.sps_init(self.k0, n, c)
        return tsps.SPSState(
            prev_action=torch.as_tensor(np.array(s.prev_action),
                                        dtype=torch.int64)[None],
            counter=torch.as_tensor(np.array(s.counter),
                                    dtype=torch.int64)[None])

    def sps_step(self, rnd, i):
        self.key, ka = jax.random.split(self.key)
        k_cnt, k_keep, _ = jax.random.split(ka, 3)
        counter = np.array(jax.random.randint(k_cnt, (1,), 5, 17))
        keep = np.array(jax.random.uniform(k_keep, (1,)))
        return (torch.as_tensor(counter, dtype=torch.int64),
                torch.as_tensor(keep), torch.full((1,), 0.5))


@needs_jax_sim
def test_serve_sps_bit_equal_jax(monkeypatch):
    """SPS online: the port's SPS, fed JAX's draws, grants JAX's actions,
    so the simulator's RSSI windows and the PRR stats are JAX's."""
    monkeypatch.setattr(jgw, "build_simulator", jax_sim_binary)
    sim_kw = dict(sim_users=4, sim_channels=3, sim_rounds=45, sim_seed=9,
                  sim_mode="sps")
    jenv = JaxRecordingEnv(port=0, sim_start=True, **sim_kw)
    try:
        jstats = jserve.serve_sps(jenv, rounds=40, seed=0)
        _finish(jenv)
    finally:
        jenv.close()
    tenv = PortRecordingEnv(port=0, sim_start=True, **sim_kw)
    try:
        tstats = tserve.serve_sps(tenv, rounds=40, device="cpu",
                                  draws=JaxSPSDraws(0))
        _finish(tenv)
    finally:
        tenv.close()
    assert len(set(jenv.actions)) > 1
    assert tenv.actions == jenv.actions
    _assert_same_stream(tenv.stream, jenv.stream)
    assert {k: tstats[k] for k in ("rounds", "mean_prr", "mean_prr_tail")} \
        == jstats


# -- SNAlignedEpisodes under shuffled, duplicated and lost rewards ----------

def _jax_sink(rep, s, a, r):
    return jdqn.add_episode(rep, jnp.asarray(s, jnp.float32),
                            jnp.asarray(a, jnp.int32),
                            jnp.asarray(r, jnp.float32), terminated=False)


def _port_sink(rep, s, a, r):
    tdqn.add_episode(rep, torch.from_numpy(s), torch.from_numpy(a),
                     torch.from_numpy(r), terminated=False)
    return rep


@pytest.mark.parametrize("replay", ["episodes", "transitions"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sn_alignment_flush_bit_equal_jax(replay, seed):
    """Per agent and window: some observations dropped, rewards delivered
    shuffled, some twice (set-once), some never (lost: the slot must
    disarm) and some a window late; after every flush the replay and the
    slot flags equal JAX's."""
    rng = np.random.RandomState(seed)
    A, W, D, windows = 3, 6, 4, 7
    ours = tserve.SNAlignedEpisodes(A, W, D)
    theirs = jserve.SNAlignedEpisodes(A, W, D)
    if replay == "episodes":
        trep = tps.EpisodeReplay.create(A, W, D)
        jrep = jps.EpisodeReplay.create(A, W, D)
        tsink = jsink = None
    else:
        trep, jrep = TransitionReplay.create(64, D), JTransitionReplay.create(64, D)
        tsink, jsink = _port_sink, _jax_sink
    carry = []
    for w in range(windows):
        # rewards a window late; some of them arrive once more later on
        events = [("r", *x) for x in carry]
        carry = [x for x in carry if rng.rand() < 0.3]
        for a in range(A):
            for sn in range(w * W, (w + 1) * W):
                if rng.rand() > 0.1:
                    state = rng.randn(D).astype(np.float64)
                    events.append(("sa", a, sn, state, int(rng.randint(5))))
                fate = rng.rand()
                reward = float(rng.randn())
                if fate < 0.1:
                    continue                              # lost
                if fate < 0.2:
                    carry.append((a, sn, reward))         # next window
                    continue
                events.append(("r", a, sn, reward))
                if fate < 0.35:
                    events.append(("r", a, sn, reward + 1.0))  # duplicate
        for k in rng.permutation(len(events)):
            ev = events[k]
            for ep in (ours, theirs):
                if ev[0] == "sa":
                    ep.record_obs_act(*ev[1:])
                else:
                    ep.record_reward(*ev[1:])
        trep = ours.flush(trep, tsink)
        jrep = theirs.flush(jrep, jsink)
        _assert_same_snapshots([_snapshot(trep)], [_snapshot(jrep)])
        for k in ("states", "actions", "rewards", "has_sa", "has_r",
                  "sa_age"):
            assert getattr(ours, k).tobytes() == getattr(theirs, k).tobytes()
    assert _snapshot(trep)["count"] > 0


# -- counterparts of tests/test_serve.py -------------------------------------

def test_sn_alignment_set_once_and_completeness():
    ep = tserve.SNAlignedEpisodes(num_agents=2, capacity=8, state_dim=3)
    ep.record_obs_act(0, 0, np.ones(3), 2)
    ep.record_obs_act(0, 0, np.zeros(3), 1)  # set-once: ignored
    np.testing.assert_array_equal(ep.states[0, 0], np.ones(3))
    assert ep.actions[0, 0] == 2
    rep = ep.flush(tps.EpisodeReplay.create(2, max_len=8, state_dim=3))
    assert rep.count == 0
    ep.record_obs_act(0, 1, np.full(3, 2.0), 0)
    ep.record_reward(0, 1, 0.5)
    rep = ep.flush(rep)
    assert rep.count == 1
    assert int(rep.lengths[0]) == 1
    assert float(rep.rewards[0, 0]) == 0.5


def test_sn_alignment_lost_reward_disarms():
    cap = 4
    ep = tserve.SNAlignedEpisodes(num_agents=1, capacity=cap, state_dim=2)
    rep = tps.EpisodeReplay.create(4, max_len=8, state_dim=2)
    ep.record_obs_act(0, 0, np.full(2, 7.0), 3)   # reward lost forever
    rep = ep.flush(rep)                           # window 1: still armed
    assert ep.has_sa[0, 0]
    rep = ep.flush(rep)                           # window 2: disarmed
    assert not ep.has_sa[0, 0]
    ep.record_obs_act(0, cap, np.full(2, 9.0), 1)
    ep.record_reward(0, cap, 0.25)
    rep = ep.flush(rep)
    assert rep.count == 1
    np.testing.assert_array_equal(rep.states[0, 0].numpy(), np.full(2, 9.0))
    assert int(rep.actions[0, 0]) == 1
    ep.record_obs_act(0, 5, np.full(2, 3.0), 2)
    rep = ep.flush(rep)
    ep.record_reward(0, 5, 0.5)
    rep = ep.flush(rep)
    assert rep.count == 2
    assert float(rep.rewards[1, 0]) == 0.5


def test_neighbor_dist_type1_all_phantom_no_nan():
    import warnings

    table = {i: {"xpos": 0.0, "ypos": 0.0, "seq_number": 0,
                 "last_updated": 0} for i in range(4)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hist = tgw.neighbor_dist_type1(0, table, bins=10)
    np.testing.assert_array_equal(hist, np.zeros(10))


def _serve(env_kw, loop, **kw):
    env = tgw.GatewayEnv(port=0, sim_start=True, **env_kw)
    try:
        out = loop(env, device="cpu", **kw)
        _finish(env)
    finally:
        env.close()
    return env, out


@needs_gxx
def test_serve_and_learn_end_to_end():
    _, (learner, stats) = _serve(
        dict(sim_users=4, sim_channels=3, sim_rounds=80, sim_seed=3,
             state_design=2, pos_dist=2, state_bins=10, state_range=250,
             reward_design=2),
        tserve.serve_and_learn, cfg=_cfg(tconfig), rounds=75,
        train_every=15, n_batches=2, eps=0.3)
    assert stats["train_calls"] >= 4
    assert np.isfinite(stats["losses"]).all()
    assert -1.0 <= stats["mean_reward"] <= 1.0
    assert all(p.device.type == "cpu" for p in learner.params.parameters())
    t = stats["timing"]
    assert t["requests"] == 300 and t["seconds"] > 0
    assert t["wait_s"] + t["infer_s"] + t["train_s"] <= t["seconds"]


@needs_gxx
def test_serve_and_learn_rssi_syn_mode():
    env, (_, stats) = _serve(
        dict(sim_users=4, sim_channels=3, sim_rounds=80, sim_seed=7,
             sim_mode="syn"),
        tserve.serve_and_learn, cfg=_cfg(tconfig), rounds=75,
        train_every=15, n_batches=1, eps=0.4, mode="syn")
    assert env.state_type == 2
    assert env.obs_size == 3
    assert stats["train_calls"] >= 4
    assert np.isfinite(stats["losses"]).all()
    assert -np.e <= stats["mean_reward"] <= 1.0
    assert 0.0 <= stats["mean_prr_tail"] <= 1.0


@needs_gxx
def test_serve_ps_dqn_end_to_end():
    _, (_, stats) = _serve(
        dict(sim_users=4, sim_channels=3, sim_rounds=80, sim_seed=11,
             sim_mode="syn"),
        tserve.serve_and_learn_dqn, cfg=_cfg(tconfig, dqn=True), rounds=75,
        train_every=15, n_batches=2, eps=0.5, eps_final=0.05)
    assert stats["train_calls"] >= 4
    assert np.isfinite(stats["losses"]).all()
    assert 0.0 <= stats["mean_prr_tail"] <= 1.0


@needs_gxx
def test_serve_sps_over_gateway():
    _, stats = _serve(dict(sim_users=4, sim_channels=3, sim_rounds=60,
                           sim_seed=9, sim_mode="sps"),
                      tserve.serve_sps, rounds=55, seed=0)
    assert 0.0 <= stats["mean_prr"] <= 1.0
    assert 0.0 <= stats["mean_prr_tail"] <= 1.0


@needs_gxx
def test_serve_distance_based_reward():
    _, (_, stats) = _serve(
        dict(sim_users=4, sim_channels=3, sim_rounds=50, sim_seed=2,
             distance_based_reward=True),
        tserve.serve_and_learn, cfg=_cfg(tconfig), rounds=45,
        train_every=15, n_batches=1, eps=0.4)
    assert stats["train_calls"] >= 2
    assert np.isfinite(stats["losses"]).all()
    assert -4.0 <= stats["mean_reward"] <= 1.0


@needs_gxx
def test_serve_and_learn_state_design_1():
    """state_design=1 advertises action + obs_size, but the served state is
    the state_bins histogram: the learner is sized to what is served."""
    _, (learner, stats) = _serve(
        dict(sim_users=4, sim_channels=3, sim_rounds=40, sim_seed=5,
             state_design=1, pos_dist=1, state_bins=12, state_range=250,
             reward_design=2),
        tserve.serve_and_learn, cfg=_cfg(tconfig), rounds=35,
        train_every=10, n_batches=1, eps=0.5)
    assert stats["train_calls"] >= 2
    assert np.isfinite(stats["losses"]).all()
    first = next(iter(learner.params.parameters()))
    assert 12 in first.shape


# -- the serve verb -----------------------------------------------------------

_JAX_KEYS = {
    "drqn": {"rounds", "mean_reward", "mean_prr", "mean_prr_tail",
             "train_calls", "losses"},
    "sps": {"rounds", "mean_prr", "mean_prr_tail"},
}


@needs_gxx
@pytest.mark.parametrize("mode", ["drqn", "drqn-rssi", "ps-dqn", "sps",
                                  "compare"])
def test_serve_verb_modes(mode, capsys):
    cli.main(["serve", "--device", "cpu", "--mode", mode, "--users", "4",
              "--channels", "3", "--rounds", "30"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    if mode == "compare":
        assert set(out) == {"drqn", "sps", "prr_improvement"}
        assert set(out["drqn"]) - {"timing"} == _JAX_KEYS["drqn"] - {"losses"}
        assert set(out["sps"]) - {"timing"} == _JAX_KEYS["sps"]
        assert out["prr_improvement"] == pytest.approx(
            out["drqn"]["mean_prr_tail"] - out["sps"]["mean_prr_tail"])
        assert out["drqn"]["train_calls"] == 3
        return
    keys = _JAX_KEYS["sps" if mode == "sps" else "drqn"]
    assert set(out) - {"timing"} == keys
    assert out["rounds"] == 30
    assert out["timing"]["requests"] == 120
    assert 0.0 <= out["mean_prr_tail"] <= 1.0
    if mode != "sps":
        assert out["train_calls"] == 3 and len(out["losses"]) == 3


@needs_gxx
def test_serve_campaign_artifact(tmp_path):
    """The seed-replication script writes JAX's artifact shape: protocol,
    cli, rows of (drqn, sps, prr_improvement, seed, wall_seconds) and the
    distribution, plus the device."""
    from diral_tpu_torch.scripts import serve_campaign

    out = tmp_path / "band.json"
    serve_campaign.main([str(out), "--seeds", "2", "--rounds", "20",
                         "--users", "4", "--channels", "3", "--device",
                         "cpu"])
    res = json.loads(out.read_text())
    assert {"protocol", "cli", "rows", "prr_improvement_mean",
            "prr_improvement_std", "prr_improvement_min",
            "prr_improvement_max", "n_below_sps", "device"} <= set(res)
    assert [r["seed"] for r in res["rows"]] == [0, 1]
    for r in res["rows"]:
        assert {"drqn", "sps", "prr_improvement", "seed",
                "wall_seconds"} <= set(r)
        assert r["drqn"]["train_calls"] == 2
        assert r["prr_improvement"] == pytest.approx(
            r["drqn"]["mean_prr_tail"] - r["sps"]["mean_prr_tail"])
    assert res["device"]["name"] == "cpu"
    assert res["n_below_sps"] == sum(r["prr_improvement"] <= 0
                                     for r in res["rows"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_serve_verb_needs_a_gpu_without_device_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--mode", "sps", "--rounds", "1"])
