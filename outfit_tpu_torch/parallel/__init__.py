"""Data parallelism over devices: trajectory rows split over a device list.

Port of ``outfit_tpu/parallel``.  The reference's only parallelism is a
thread pool over trajectories (``obs_dataset_api.rs:174-207``); the JAX
package shards the lane and trajectory batches over a 1-D ``jax.sharding``
mesh.  In the port a mesh is a tuple of ``torch.device``: a fit entry point
given several devices (``device=[...]`` or ``"auto"``) builds what sees the
whole batch once, gives each device a contiguous chunk of trajectory rows
in a worker thread of its own, and joins the results in dataset order.
"""

from outfit_tpu_torch.parallel.sharding import (
    auto_mesh,
    data_mesh,
    pad_to_multiple,
    replicate,
    resolve_mesh,
    shard_batch,
)

__all__ = ["auto_mesh", "data_mesh", "pad_to_multiple", "replicate", "resolve_mesh", "shard_batch"]
