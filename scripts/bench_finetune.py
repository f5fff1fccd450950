"""Fine-tune throughput: train steps/s at batch 512 and the GRU backward A/B.

Three numbers:

  1. full InfoNCE+alignment train step (parallel/train.py) steps/s at
     --batch 512 — the end metric (shift/indel/noise-matched tuning is the
     accuracy lever and is retrained per deployment);
  2. fwd+bwd through ONE bidirectional gru_bi layer with the manual-VJP
     backward (parallel gate recompute + cotangent recurrence);
  3. the same fwd+bwd with plain autodiff through the lax.scan reference —
     the round-1 backward cost shape (sequential forward re-run + scan
     autodiff).  (2)/(3) is the backward speedup; target >= 1.5x.

Run from the repo root: python scripts/bench_finetune.py [--cpu] [--batch 512]
"""

import argparse
import json
import time

import numpy as np
import jax


def sync(x):
    jax.block_until_ready(x)


def timeit(fn, *args, iters=5):
    sync(fn(*args))  # warm/compile
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.time() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import sys

    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from deepreadmapper_tpu.models import gru_pallas as gp
    from deepreadmapper_tpu.models.encoder import load_params
    from deepreadmapper_tpu.parallel.mesh import make_mesh
    from deepreadmapper_tpu.parallel.train import (
        make_optimizer,
        make_train_step,
    )

    b, t, din = args.batch, 123, 64
    rng = np.random.default_rng(0)

    # --- (1) full train step at batch b ---
    params = load_params()
    optimizer = make_optimizer()
    opt_state = optimizer.init(params)
    mesh = make_mesh(n_data=len(jax.devices()), n_shard=1)
    step = make_train_step(optimizer, mesh)
    reads = jnp.asarray(rng.integers(7542, 7638, (b, t)).astype(np.int32))
    wins = jnp.asarray(rng.integers(7542, 7638, (b, t)).astype(np.int32))

    def one_step(p, o):
        p2, o2, loss = step(p, o, reads, wins)
        return loss

    dt_step = timeit(one_step, params, opt_state, iters=args.iters)

    # --- (2) vs (3): one bi-GRU layer fwd+bwd, manual VJP vs scan autodiff
    x = jnp.asarray(rng.standard_normal((t, b, din)).astype(np.float32))
    w = jnp.asarray(
        rng.standard_normal((2, din, gp.G)).astype(np.float32) * 0.1
    )
    bzr = jnp.zeros((2, gp.G), jnp.float32)
    r_mat = jnp.asarray(
        rng.standard_normal((2, gp.H, gp.G)).astype(np.float32) * 0.1
    )
    rbh = jnp.zeros((2, gp.H), jnp.float32)

    @jax.jit
    def fb_manual(x, w, bzr, r_mat, rbh):
        def loss(*a):
            return jnp.sum(gp.gru_bi(*a, False) ** 2)

        return jax.grad(loss, argnums=(0, 1, 3))(x, w, bzr, r_mat, rbh)

    @jax.jit
    def fb_autodiff(x, w, bzr, r_mat, rbh):
        def loss(*a):
            return jnp.sum(gp._scan_bi(*a, False) ** 2)

        return jax.grad(loss, argnums=(0, 1, 3))(x, w, bzr, r_mat, rbh)

    dt_manual = timeit(fb_manual, x, w, bzr, r_mat, rbh, iters=args.iters)
    dt_auto = timeit(fb_autodiff, x, w, bzr, r_mat, rbh, iters=args.iters)

    print(json.dumps({
        "backend": jax.default_backend(),
        "batch": b,
        "train_steps_per_s": round(1.0 / dt_step, 3),
        "gru_fwdbwd_manual_ms": round(dt_manual * 1e3, 2),
        "gru_fwdbwd_scan_autodiff_ms": round(dt_auto * 1e3, 2),
        "backward_speedup": round(dt_auto / dt_manual, 2),
    }))


if __name__ == "__main__":
    main()
