"""Encoder fine-tuning pipeline.

The shipped model is "finetuned_sgn33" — a fine-tuned bi-GRU.  This module
provides the training loop that produces such models: self-supervised
(read, source-window) pairs are generated by sampling windows from a reference
genome and simulating reads from them (substitution noise), then the sharded
InfoNCE train step (parallel/train.py) aligns read embeddings with their
source windows across the device mesh.
"""

from __future__ import annotations

import numpy as np

from deepreadmapper_tpu import tokenizer as tok
from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.models import encoder as enc
from deepreadmapper_tpu.models.encoder import EncoderParams


def _indel_augment(
    mat: np.ndarray,
    lens: np.ndarray,
    rng: np.random.Generator,
    rate: float,
    width: int,
    ref_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Apply random single-base insertions and deletions (each at `rate`
    per base) to the BASE region of wrapped read rows; the '<'/'>' wrap
    bytes are never mutated.  Rows were fetched with slack columns so
    deletions still fill `width`.

    Length semantics match real wrapped reads: out_lens is the TRUE
    (pre-truncation) wrapped length, adjusted by the net indel count, so the
    tokenizer's end-of-sequence handling fires exactly when it would for a
    served read of the same length (a truncated 150 bp read never produces
    a suffix-class final token; a short read does)."""
    w_in = mat.shape[1]
    base_n = min(ref_len, w_in - 1)  # base columns: [1, 1+base_n); '>' later
    out = np.zeros((mat.shape[0], width), dtype=mat.dtype)
    out_lens = np.empty_like(lens)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(mat.shape[0]):
        body = mat[i, 1 : 1 + base_n]
        keep = rng.random(body.size) >= rate
        kept = body[keep]
        n_del = base_n - kept.size
        n_ins = int(rng.binomial(kept.size, rate))
        if n_ins:
            pos = np.sort(rng.integers(0, kept.size + 1, n_ins))
            kept = np.insert(kept, pos, acgt[rng.integers(0, 4, n_ins)])
        n = min(kept.size, width - 1)
        out[i, 0] = mat[i, 0]
        out[i, 1 : 1 + n] = kept[:n]
        true_len = max(2, int(lens[i]) + n_ins - n_del)
        if true_len <= width:  # short read: the terminator is materialized
            out[i, true_len - 1] = ord(">")
        out_lens[i] = true_len
    return out, out_lens


def sample_pairs(
    genome: np.ndarray,
    ref_len: int,
    batch: int,
    rng: np.random.Generator,
    sub_rate: float = 0.01,
    max_len: int = 123,
    max_shift: int = 0,
    indel_rate: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (read_tokens, window_tokens) int32 [batch, max_len]: random
    genome windows (either strand) and noisy simulated reads from them.

    max_shift > 0 additionally offsets each read's start by 0..max_shift
    bases from its window (shift-matched training for SPARSE serving: with
    stride s, real reads start up to s-1 bases off the nearest indexed
    window, a mismatch substitution noise alone never teaches — measured to
    cap sparse top-1 at genome scale regardless of candidate count).

    indel_rate > 0 additionally applies single-base insertions and
    deletions (each at that per-base rate) to the read — long-read error
    profiles (PacBio/ONT) are indel-dominated, and an indel shifts every
    downstream 3-mer the same way a start-offset does.
    """
    glen = genome.size
    pos = rng.integers(0, glen - ref_len + 1, size=batch)
    strand = rng.integers(0, 2, size=batch)
    ids = (pos << 1) | strand
    w_mat, w_lens = fasta_io.fetch_windows_by_id(genome, ids, ref_len, max_len, wrap=True)
    fetch_len = max_len + 8 if indel_rate > 0 else max_len  # deletion slack
    if max_shift > 0:
        delta = rng.integers(0, max_shift + 1, size=batch)
        pos_r = np.clip(pos + delta, 0, glen - ref_len)
        r_ids = (pos_r << 1) | strand
        r_mat, r_lens = fasta_io.fetch_windows_by_id(
            genome, r_ids, ref_len, fetch_len, wrap=True
        )
    elif indel_rate > 0:
        r_mat, r_lens = fasta_io.fetch_windows_by_id(
            genome, ids, ref_len, fetch_len, wrap=True
        )
    else:
        r_mat, r_lens = w_mat.copy(), w_lens
    # Substitution noise in the read body — BEFORE indels, so the slice
    # [1, ref_len+1) only ever contains bases (after augmentation a short
    # read's '>' terminator can move inside that range).
    body = r_mat[:, 1 : min(ref_len + 1, r_mat.shape[1])]
    noise = rng.random(body.shape) < sub_rate
    subs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=body.shape)]
    r_mat[:, 1 : 1 + body.shape[1]] = np.where(noise, subs, body)
    if indel_rate > 0:
        # rows are max_len+1 wide like every fetched byte matrix (the
        # tokenizer reads max_len+1 columns; one narrower and the final
        # 3-mer hashes a padding byte)
        r_mat, r_lens = _indel_augment(
            r_mat, r_lens, rng, indel_rate, max_len + 1, ref_len
        )
    rt = tok.tokenize_bytes_fast(r_mat, r_lens, max_len)
    wt = tok.tokenize_bytes_fast(w_mat, w_lens, max_len)
    return rt, wt


def finetune(
    ref_file: str,
    ref_len: int,
    steps: int = 100,
    batch: int = 512,
    lr: float = 1e-4,
    seed: int = 0,
    params: EncoderParams | None = None,
    mesh=None,
    sub_rate: float = 0.01,
    max_shift: int = 0,
    indel_rate: float = 0.0,
    state_path: str | None = None,
) -> tuple[EncoderParams, list[float]]:
    """Run fine-tuning; returns (params, per-step losses).

    state_path: when given, the FULL training state (params + optimizer
    moments + step counter + data-rng position) is loaded from it if it
    exists and saved back after training — exact checkpoint/resume,
    unlike the weights-only npz path."""
    import os

    import jax.numpy as jnp

    from deepreadmapper_tpu.parallel.mesh import make_mesh
    from deepreadmapper_tpu.parallel.train import make_optimizer, make_train_step

    genome = fasta_io.extract_fasta_sequence(ref_file)
    params = params if params is not None else enc.load_params()
    mesh = mesh or make_mesh(n_shard=1)
    optimizer = make_optimizer(lr)
    opt_state = optimizer.init(params)
    step_done = 0
    rng = np.random.default_rng(seed)
    if state_path is not None:
        # np.savez appends .npz to extensionless paths — normalize up front
        # so the resume check and the save always agree.
        if not state_path.endswith(".npz"):
            state_path += ".npz"
        d = os.path.dirname(state_path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(state_path):
            params, opt_state, step_done, rng = load_train_state(
                state_path, (params, opt_state)
            )
            print(f"[FINETUNE] resumed from {state_path} at step {step_done}")
        else:
            print(f"[FINETUNE] no state at {state_path}, starting fresh")
    step_fn = make_train_step(optimizer, mesh)
    losses: list[float] = []
    for _ in range(steps):
        rt, wt = sample_pairs(
            genome, ref_len, batch, rng, sub_rate=sub_rate,
            max_shift=max_shift, indel_rate=indel_rate,
        )
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(rt), jnp.asarray(wt)
        )
        losses.append(float(loss))
    if state_path is not None:
        save_train_state(state_path, params, opt_state, step_done + steps, rng)
    return params, losses


def save_train_state(path: str, params, opt_state, step: int, rng) -> None:
    """Full training-state checkpoint: every array leaf of (params,
    opt_state) plus the step counter and numpy rng state, one npz."""
    import os
    import pickle

    import jax

    leaves, _ = jax.tree_util.tree_flatten((params, opt_state))
    payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    payload["step"] = np.int64(step)
    payload["rng_state"] = np.frombuffer(
        pickle.dumps(rng.bit_generator.state), dtype=np.uint8
    )
    if not path.endswith(".npz"):
        path += ".npz"
    # Atomic replace: a crash mid-save must not corrupt the only checkpoint.
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_train_state(path: str, template):
    """Inverse of save_train_state; `template` provides the pytree structure
    (params, opt_state) to unflatten into."""
    import pickle

    import jax
    import jax.numpy as jnp

    z = np.load(path)
    _, treedef = jax.tree_util.tree_flatten(template)
    n = len([k for k in z.files if k.startswith("leaf_")])
    leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
    params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    rng = np.random.default_rng()
    rng.bit_generator.state = pickle.loads(z["rng_state"].tobytes())
    return params, opt_state, int(z["step"]), rng


def save_params_npz(params: EncoderParams, path: str) -> None:
    """Persist fine-tuned weights in the framework npz format (loadable by
    models.encoder.load_params)."""
    import numpy as np

    # Re-pack into the IR-layout arrays the loader expects.
    def unpack(p):
        w = np.swapaxes(np.asarray(p.w), 1, 2)
        r = np.swapaxes(np.asarray(p.r), 1, 2)
        bzr = np.asarray(p.bzr)
        rbh = np.asarray(p.rbh)
        b = np.concatenate([bzr[:, :128], bzr[:, 128:192], rbh], axis=1)
        return w, r, b

    w1, r1, b1 = unpack(params.layers[0])
    w2, r2, b2 = unpack(params.layers[1])
    np.savez_compressed(
        path,
        embedding=np.asarray(params.embedding).astype(np.float16),
        gru1_W=w1.astype(np.float16),
        gru1_R=r1.astype(np.float16),
        gru1_B=b1.astype(np.float16),
        gru2_W=w2.astype(np.float16),
        gru2_R=r2.astype(np.float16),
        gru2_B=b2.astype(np.float16),
    )
