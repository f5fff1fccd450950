"""Index-sharded exact search with all-gather top-k merge.

The multi-host scale-out the reference lacks (SURVEY.md §2.7): reference
vectors are sharded over the 'shard' mesh axis, queries are replicated across
shards (and data-parallel over 'data'), each shard computes a local top-k with
shard-global ids, then per-shard results merge via all_gather + lax.top_k.
XLA inserts the collectives from shard_map and hands them to NCCL on the
GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deepreadmapper_tpu.ops.topk import _topk_once


def sharded_l2_topk(queries, refs, k: int, mesh: Mesh):
    """queries [Q, D] (sharded over 'data'), refs [N, D] (sharded over
    'shard'; N must divide evenly — pad with +inf rows beforehand if needed).

    Returns (dists [Q, k], global ids [Q, k]).
    """
    n_shard = mesh.shape["shard"]
    n = refs.shape[0]
    if n % n_shard:
        raise ValueError(f"refs rows {n} not divisible by shard axis {n_shard}")
    shard_rows = n // n_shard

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data", None), P("shard", None)),
        out_specs=(P("data", None), P("data", None)),
        # After the all_gather + top_k merge, outputs are identical across the
        # 'shard' axis; the static replication checker can't prove it.
        check_vma=False,
    )
    def _search(q_local, r_local):
        qn = jnp.sum(q_local * q_local, axis=-1)
        d, i = _topk_once(q_local, r_local, qn, min(k, shard_rows))
        # Localize ids to the global index space.
        offset = jax.lax.axis_index("shard") * shard_rows
        i = i + offset
        # Merge across shards: gather every shard's candidates then re-top-k.
        d_all = jax.lax.all_gather(d, "shard", axis=1, tiled=True)  # [q, S*k]
        i_all = jax.lax.all_gather(i, "shard", axis=1, tiled=True)
        neg, pos = jax.lax.top_k(-d_all, k)
        return -neg, jnp.take_along_axis(i_all, pos, axis=1)

    q = jax.device_put(
        jnp.asarray(queries, jnp.float32), NamedSharding(mesh, P("data", None))
    )
    r = jax.device_put(
        jnp.asarray(refs, jnp.float32), NamedSharding(mesh, P("shard", None))
    )
    return _search(q, r)
