"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference, for every algorithm: the initial topology, the seed
of the run's random draws, and the envs that the check samples.  An
algorithm's own inputs (DRQN: the Q-net's initial weights) are its
module's ``weights``, made from ``generator(seed, 2, device)``.
Everything is made on the run's device, in a few large calls."""

from __future__ import annotations

import torch

CHECK_ENVS = 32   # envs whose every slot of the set-up the reference follows


def sub_seed(seed: int, k: int) -> int:
    """A generator seed for the k-th use of ``seed`` (any whole number up
    to a little over 2**31, or beyond)."""
    return (int(seed) * 1_000_003 + k * 7_919 + 1) % (2 ** 63 - 1)


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, k))


def topology(cfg, seed: int, device):
    """(pos_x, pos_y, vel, direction), each [B, N] float32: integer x in
    [0, L), integer y in [0, H // 2), speed 1.7 under mobility_vary (else
    uniform in [1.1, 2.7)), all moving right."""
    env = cfg.env
    if not env.mobility:
        raise ValueError("the benchmark's topology needs mobility")
    B, N = cfg.engine.num_envs, env.num_users
    g = generator(seed, 1, device)
    f32 = torch.float32
    pos_x = torch.randint(0, env.highway_length, (B, N), generator=g,
                          device=device).to(f32)
    half = env.highway_height // 2
    pos_y = (torch.randint(0, half, (B, N), generator=g, device=device)
             .to(f32) if half >= 1
             else torch.zeros((B, N), dtype=f32, device=device))
    if env.mobility_vary:
        vel = torch.full((B, N), 1.7, dtype=f32, device=device)
    else:
        vel = torch.empty((B, N), dtype=f32, device=device).uniform_(
            1.1, 2.7, generator=g)
    return pos_x, pos_y, vel, torch.ones((B, N), dtype=f32, device=device)


def draws_generator(seed: int, device) -> torch.Generator:
    """The generator of the run's random draws (actions, exploration,
    velocity kicks, the sampler's scores)."""
    return generator(seed, 3, device)


def check_envs(num_envs: int, seed: int) -> torch.Tensor:
    """The sorted env ids [E] whose set-up the reference follows."""
    g = torch.Generator().manual_seed(sub_seed(seed, 4))
    n = min(CHECK_ENVS, num_envs)
    return torch.randperm(num_envs, generator=g)[:n].sort().values
