"""Result dumps and console telemetry, reference-layout compatible
(the port's own copy of diral_tpu/train/metrics.py).

The reference writes per-simulation npy arrays under
``save_results/test/<experiment>/``: per-slot summed reward, the action
matrix, and x-positions (main_test.py:238-258), plus per-episode console
lines with epsilon / cumulative collisions / reward / elapsed time
(main_test.py:226-228).  Same artifact names here so downstream analysis
scripts keep working; structured JSONL goes alongside.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class ResultWriter:
    def __init__(self, root: str, experiment: str, simulation: int = 0):
        self.dir = os.path.join(root, "save_results", "test", experiment)
        os.makedirs(self.dir, exist_ok=True)
        self.sim = simulation
        self.start = time.time()
        self._jsonl = open(os.path.join(self.dir, f"metrics_sim{simulation}.jsonl"), "a")

    def save_arrays(self, rewards, actions, positions=None) -> None:
        """npy dumps with the reference's filenames (main_test.py:248-255).
        Each is written to a temporary file and renamed into place, so a
        run killed mid-write leaves the previous dump whole for --resume."""
        self._save("rewards", rewards)
        self._save("actions", actions)
        if positions is not None and np.asarray(positions).size:
            self._save("positions", positions)

    def _save(self, stem: str, array) -> None:
        path = os.path.join(self.dir, f"{stem}_sim{self.sim}.npy")
        with open(path + ".tmp", "wb") as f:
            np.save(f, np.asarray(array))
        os.replace(path + ".tmp", path)

    def episode_line(self, time_step: int, eps: float, cum_collision: float,
                     cum_reward: float) -> None:
        """Console telemetry in the reference's format (main_test.py:227-228)."""
        print(
            f"Time step {time_step} epsilon {eps} cum Collison {cum_collision}"
            f" sum reward {cum_reward} total time {time.time() - self.start}"
        )

    def log(self, record: dict) -> None:
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()

    def load_arrays(self, upto: int | None = None):
        """Load previously dumped arrays (for --resume continuity): returns
        (rewards, actions, positions) truncated to ``upto`` slots, each None
        when its file is absent."""
        out = []
        for stem in ("rewards", "actions", "positions"):
            p = os.path.join(self.dir, f"{stem}_sim{self.sim}.npy")
            a = np.load(p) if os.path.exists(p) else None
            if a is not None and upto is not None:
                a = a[:upto]
            out.append(a)
        return tuple(out)
