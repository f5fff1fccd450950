"""Device mesh construction.

The framework's parallelism (SURVEY.md §2.7, §5) is:

  * 'data'  — batch-axis data parallelism over reads (embedding, training,
              rerank); the replacement for the reference's OpenMP
              per-query loops and OpenVINO request pipelining.
  * 'shard' — index sharding: reference vectors / PQ codes partitioned
              across devices; per-shard top-k then all-gather + global
              top-k merge (the multi-host dimension the reference lacks).

On one host the cards are joined all to all (NVLink), so the mesh follows
the algorithm alone; jax.distributed extends the same mesh across hosts.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_distributed_mesh(n_shard: int, devices=None) -> Mesh:
    """('data','shard') mesh for multi-process serving: SHARD columns are
    contiguous device blocks, aligned with own_shards' contiguous
    per-process shard assignment — shard s's devices belong to the process
    that loaded shard s's files.  Each data row takes one device from
    EVERY shard column, so every process holds every query block and the
    merged results are fully addressable everywhere (the replicated-query
    contract).  n_data = devices // n_shard."""
    devices = devices if devices is not None else jax.devices()
    nd = len(devices)
    if nd % n_shard:
        raise ValueError(
            f"{nd} devices cannot hold {n_shard} equal shard columns; "
            "choose a shard count dividing the device count"
        )
    n_data = nd // n_shard
    arr = np.asarray(devices).reshape(n_shard, n_data).T
    return Mesh(arr, axis_names=("data", "shard"))


def make_mesh(
    n_data: int | None = None,
    n_shard: int = 1,
    devices=None,
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // n_shard
    n = n_data * n_shard
    if n > len(devices):
        raise ValueError(f"mesh {n_data}x{n_shard} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(n_data, n_shard)
    return Mesh(arr, axis_names=("data", "shard"))
