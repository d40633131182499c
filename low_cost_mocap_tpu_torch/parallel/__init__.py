"""Device-mesh distribution: the camera-sharded live step, distributed
bundle adjustment, and time-sharded offline processing.

Counterpart of ``low_cost_mocap_tpu/parallel/``.  The JAX package lays
views over a ``cam`` mesh axis, BA residual blocks over ``point`` and long
recordings over ``time``, and joins the shards with XLA collectives
(``psum``, ``all_gather``, ``ppermute``).  Here a ``Mesh`` names the
devices of each shard; in one process the shards run one after another on
their devices and meet on the mesh's first device, and across processes
they meet through ``torch.distributed`` collectives whose order is fixed
(an ``all_gather``, then a sum in shard order), so every layout of the
same shards gives the same bits.
"""
