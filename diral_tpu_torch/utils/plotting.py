"""Topology and training-trace visualization (the port's own copy of
diral_tpu/utils/plotting.py; the reference's debug plot, network.py:609-633
``plot_fc``, grown into something useful: highway topology with
communication-range circles, resource-usage timelines, and learning curves
from the runner's npy dumps).

Host-side only: numpy arrays in (a tensor goes through ``np.asarray``, so
a CUDA tensor must come to the host first), a PNG out.  matplotlib is
imported inside each function, on the Agg backend, so that importing this
module needs none; nothing on a training or serving path calls it.
"""

from __future__ import annotations

import numpy as np


def plot_topology(pos_x, pos_y, actions=None, communication_range=None,
                  highway_length=None, path="topology.png"):
    """Scatter the vehicles on the highway; color by chosen resource.
    Equivalent in spirit to network.py:609-633."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos_x, pos_y = np.asarray(pos_x), np.asarray(pos_y)
    fig, ax = plt.subplots(figsize=(10, 2.5))
    c = np.asarray(actions) if actions is not None else None
    sc = ax.scatter(pos_x, pos_y, c=c, cmap="tab10", s=120, zorder=3)
    for i, (x, y) in enumerate(zip(pos_x, pos_y)):
        ax.annotate(str(i), (x, y), ha="center", va="center", zorder=4,
                    fontsize=8, color="white")
        if communication_range:
            ax.add_patch(
                __import__("matplotlib.patches", fromlist=["Circle"]).Circle(
                    (x, y), communication_range, fill=False, alpha=0.15,
                    zorder=1,
                )
            )
    if highway_length:
        ax.set_xlim(-5, highway_length + 5)
    if actions is not None:
        fig.colorbar(sc, ax=ax, label="resource")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("lane")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_action_timeline(actions, path="actions.png", max_slots=500):
    """Resource choice per user over time ([T, N] int matrix, the
    actions_sim*.npy artifact)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(actions)
    if a.ndim == 3:  # [T, B, N]: first env instance
        a = a[:, 0]
    a = a[-max_slots:]
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(a.T, aspect="auto", interpolation="nearest", cmap="tab10")
    ax.set_xlabel("slot")
    ax.set_ylabel("user")
    fig.colorbar(im, ax=ax, label="resource")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_learning_curve(rewards, path="rewards.png", window=500):
    """Smoothed per-slot sum reward (the rewards_sim*.npy artifact)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = np.asarray(rewards)
    if r.ndim == 2:  # [T, B]: mean over envs
        r = r.mean(axis=1)
    kernel = np.ones(window) / window
    smooth = np.convolve(r, kernel, mode="valid")
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(smooth)
    ax.set_xlabel("slot")
    ax.set_ylabel(f"sum reward ({window}-slot mean)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
