"""Multi-host initialization and per-host index-shard orchestration.

The reference is single-process (SURVEY.md §2.7); scale-out is this
framework's addition.  The deployment model:

  * `init_distributed()` — jax.distributed.initialize() on every host;
    afterwards jax.devices() spans every host and `make_mesh` builds a
    ('data','shard') mesh whose collectives XLA hands to NCCL (NVLink
    within a host, the network across hosts).
  * The genome's PQ codes / vectors are sharded row-wise over 'shard'.  Each
    host owns a contiguous block of shards (`own_shards`), embeds/encodes ONLY
    its window ranges (`plan_shards` computes them), and persists them with
    `build_own_shards`; process 0 writes the manifest.  `load_own_shards`
    restores just the host-local sub-indexes.  Reads stream data-parallel over
    'data' and per-shard top-k merges with all_gather + lax.top_k
    (sharded_ann.py / sharded_search.py).
  * Checkpoint story: each host persists its own shard (index_prefix/shard_i),
    sharded.txt records the plan, and any process count that divides the
    shard count can reload.

The shard files written here are byte-compatible with the single-process
`ShardedANNIndex.build(...).save(...)` path: both pad the tail shard by
repeating the final row so every shard holds the same padded row count, and
both mask pad rows at merge time via the manifest's ntotal.
"""

from __future__ import annotations

import os

import numpy as np

import jax

from deepreadmapper_tpu.config import BuildConfig
from deepreadmapper_tpu.index.registry import _REGISTRY


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize wrapper; no-op on single-process setups
    where env-based auto-detection applies."""
    if num_processes is None and coordinator_address is None:
        try:
            jax.distributed.initialize()
        except Exception:
            pass  # single-process / already initialized
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def plan_shards(n_vectors: int, n_shards: int) -> list[tuple[int, int]]:
    """Row ranges per shard, padded so every shard holds the same count
    (fixed shapes for the collectives); the pad rows are masked by id bound.
    Ranges clamp to [0, n_vectors] — the ceil split can leave tail shards
    empty (n=5, shards=4 -> per=2 -> shard 3 owns nothing)."""
    per = -(-n_vectors // n_shards)
    return [
        (min(s * per, n_vectors), min((s + 1) * per, n_vectors))
        for s in range(n_shards)
    ]


def own_shards(
    n_shards: int,
    process_id: int | None = None,
    num_processes: int | None = None,
) -> list[int]:
    """Shard indices THIS process owns: contiguous blocks, so a host's
    shards cover a contiguous window range of the genome (streaming embed
    reads each byte once).  Any process count that divides n_shards works —
    1 process owns everything, n_shards processes own one each."""
    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    if n_shards % nproc:
        raise ValueError(
            f"n_shards={n_shards} must be divisible by the process count "
            f"{nproc} so every host owns whole shards"
        )
    per = n_shards // nproc
    return list(range(pid * per, (pid + 1) * per))


def build_own_shards(
    embed_rows,
    n_vectors: int,
    n_shards: int,
    index_prefix: str,
    cfg: BuildConfig | None = None,
    index_type: str = "INT8FLAT",
    process_id: int | None = None,
    num_processes: int | None = None,
    codes_scale: float | None = None,
) -> list[int]:
    """Per-host build-own-shard: encode and persist ONLY this host's shards.

    embed_rows(start, end) -> [end-start, D] produces the rows for a global
    range (the caller wires it to its windowed-FASTA embedder so a host
    never touches another host's genome slice) — fp32 embeddings normally,
    or int8 CODES at the given codes_scale (the quantized fast path for
    INT8FLAT/IVFINT8: 4x less host<->device traffic and no fp32 shard in host
    RAM).  Every shard directory is self-contained (codes +
    codebook/scale), so hosts need no collective during the build —
    process 0 additionally writes sharded.txt.

    Returns the shard ids this process built.
    """
    cfg = cfg or BuildConfig()
    ranges = plan_shards(n_vectors, n_shards)
    per = ranges[0][1] - ranges[0][0]
    if per >= 2**31:
        raise NotImplementedError(
            f"{per} rows/shard exceeds the int32 local-id space; use more "
            "shards"
        )
    if codes_scale is not None and index_type not in ("INT8FLAT", "IVFINT8"):
        raise ValueError(
            f"codes_scale applies to the int8-coded engines; got {index_type}"
        )
    eng = _REGISTRY[index_type]
    mine = own_shards(n_shards, process_id, num_processes)
    os.makedirs(index_prefix, exist_ok=True)
    for si in mine:
        start, end = ranges[si]
        emb = np.asarray(embed_rows(start, end))
        if emb.shape[0] != end - start:
            raise ValueError(
                f"embed_rows({start},{end}) returned {emb.shape[0]} rows"
            )
        if emb.shape[0] < per:
            # tail shard: repeat the last real row (an entirely-empty tail
            # shard pads with the GLOBAL last row — same convention as
            # ShardedANNIndex.build's repeat-the-last-row padding)
            pad_src = (
                emb[-1:]
                if emb.shape[0]
                else np.asarray(embed_rows(n_vectors - 1, n_vectors))
            )
            emb = np.concatenate(
                [emb, np.repeat(pad_src, per - emb.shape[0], axis=0)]
            )
        if codes_scale is not None:
            if index_type == "INT8FLAT":
                sub = eng(np.asarray(emb, np.int8), codes_scale,
                          emb.shape[0])
            else:  # IVFINT8
                sub = eng.build_from_codes(
                    np.asarray(emb, np.int8), codes_scale, cfg
                )
        else:
            sub = eng.build(emb, cfg) if hasattr(eng, "build") else eng(emb)
        sub_dir = os.path.join(index_prefix, f"shard_{si}")
        os.makedirs(sub_dir, exist_ok=True)
        sub.save(sub_dir)
    pid = jax.process_index() if process_id is None else process_id
    if pid == 0:
        with open(os.path.join(index_prefix, "sharded.txt"), "w") as f:
            f.write(f"n_shard:{n_shards}\n")
            f.write(f"ntotal:{n_vectors}\n")
            f.write(f"inner:{index_type}\n")
    return mine


def load_own_shards(
    index_prefix: str,
    process_id: int | None = None,
    num_processes: int | None = None,
):
    """Load ONLY this host's sub-indexes from a sharded index directory.

    Returns (subs, shard_ids, manifest).  A host restoring a 16-shard index
    with 4 processes loads 4 sub-indexes — it never reads (or pages in)
    another host's codes.  Single-process callers get every shard, which is
    exactly `ShardedANNIndex.load`'s input."""
    from deepreadmapper_tpu.parallel.sharded_ann import read_manifest

    meta = read_manifest(index_prefix)
    n_shard = int(meta["n_shard"])
    mine = own_shards(n_shard, process_id, num_processes)
    eng = _REGISTRY[meta["inner"]]
    subs = [
        eng.load(os.path.join(index_prefix, f"shard_{si}")) for si in mine
    ]
    return subs, mine, meta
