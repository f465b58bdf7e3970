"""The parallel layer (port of ``ananke_abm_tpu/parallel``): the (agents x
zones) mesh on ``torch.distributed``, one process a device, the sharded
GAT-ODE steps and rollouts, and the ring zone encoder."""
from ananke_abm_tpu_torch.parallel.distributed import (
    global_batch_shape,
    host_local_batch_to_global,
    host_row_slice,
    maybe_initialize,
)
from ananke_abm_tpu_torch.parallel.halo import (
    encode_zones_ring,
    ring_encoder,
    ring_gat_attention,
)
from ananke_abm_tpu_torch.parallel.mesh import (
    AGENT_AXIS,
    ZONE_AXIS,
    make_mesh,
    named_sharding,
    replicate,
    shard_batch,
)
from ananke_abm_tpu_torch.parallel.sharded import (
    make_sharded_fused_train_step,
    make_sharded_rollout,
    make_sharded_train_step,
)

__all__ = ["AGENT_AXIS", "ZONE_AXIS", "make_mesh", "named_sharding",
           "shard_batch", "replicate", "global_batch_shape",
           "host_row_slice", "host_local_batch_to_global",
           "maybe_initialize", "make_sharded_train_step",
           "make_sharded_fused_train_step", "make_sharded_rollout",
           "ring_gat_attention", "ring_encoder", "encode_zones_ring"]
