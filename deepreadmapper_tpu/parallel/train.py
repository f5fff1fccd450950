"""Encoder fine-tuning step (sharded).

The shipped model is a FINE-TUNED bi-GRU ("finetuned_sgn33"); the framework
therefore supports continuing that training on the accelerator.  The objective is
embedding regression/contrastive alignment: a read's embedding should match
the embedding of its source genome window (self-supervised pairs produced by
the windowing pipeline).

Sharding: for a 64-hidden GRU the real parallelism is pure data parallelism —
batch sharded over the full mesh ('data' and 'shard' axes both act as DP for
training), parameters replicated, gradients all-reduced by jit from the
sharding annotations.  Tensor-parallel sharding of 64/192-wide matmuls would
shard below a useful matmul tile and only add latency, so it is deliberately not
used (SURVEY.md §2.7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deepreadmapper_tpu.models.encoder import EncoderParams, encode_tokens


class TrainState(NamedTuple):
    params: EncoderParams
    opt_state: optax.OptState


def make_optimizer(lr: float = 1e-4) -> optax.GradientTransformation:
    return optax.adam(lr)


def loss_fn(params: EncoderParams, read_tokens, window_tokens, temperature=0.07):
    """InfoNCE between read embeddings and their source-window embeddings,
    with in-batch negatives; plus an L2 alignment term."""
    re = encode_tokens(params, read_tokens)
    we = encode_tokens(params, window_tokens)
    re_n = re / (jnp.linalg.norm(re, axis=-1, keepdims=True) + 1e-6)
    we_n = we / (jnp.linalg.norm(we, axis=-1, keepdims=True) + 1e-6)
    logits = re_n @ we_n.T / temperature
    labels = jnp.arange(logits.shape[0])
    nce = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    align = jnp.mean(jnp.sum((re - we) ** 2, axis=-1))
    return nce + 0.1 * align


def make_train_step(optimizer: optax.GradientTransformation, mesh: Mesh):
    """Returns a jitted train step with batch sharded over BOTH mesh axes
    (pure DP) and replicated params."""
    batch_sharding = NamedSharding(mesh, P(("data", "shard"), None))
    rep = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, batch_sharding, batch_sharding),
        out_shardings=(rep, rep, rep),
    )
    def train_step(params, opt_state, read_tokens, window_tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, read_tokens, window_tokens)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
