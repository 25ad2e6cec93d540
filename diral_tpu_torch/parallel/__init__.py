"""Mesh construction and sharding (diral_tpu/parallel): DP over envs, the
learner replicated over the model axis, one process per device over
torch.distributed."""

from diral_tpu_torch.parallel.mesh import (
    env_axis,
    make_mesh,
    mesh_from_spec,
    shard_carry,
)
