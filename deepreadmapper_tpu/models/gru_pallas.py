"""Bidirectional GRU layer: a Pallas (Triton) kernel for the GPU and the
plain ``lax.scan`` formulation that XLA compiles everywhere.

The encoder's hot loop is 123 sequential steps of ``h' = GRU(h, x[t])`` per
direction per layer (the reference runs this inside OpenVINO's GRUSequence
op, models/finetuned_sgn33-new-a-Apr6.xml layers 49/70).  As a ``lax.scan``
each step is a few small launches ([B,din]x[din,192] projection, [B,64]x
[64,192] recurrence, gate math) that re-read and re-write the carry in
device memory.  The kernel instead runs one block per (batch tile,
direction): the block keeps ``h`` [bt,64] in registers for all T steps,
reads only ``x[t]`` from device memory each step, and fuses the input
projection, the recurrence product and the gate math.  Both directions run
in one launch; the reverse direction walks time backwards by index, so no
flipped copy of ``x`` exists.

Layout contract:
  x    [T, B, din] time-major
  seq  [T, B, 128] hidden state after step t in ORIGINAL time positions,
                   forward in [..., :64], backward in [..., 64:]
  last [B, 128]    final carries (forward at t=T-1, backward at t=0)

Triton wants power-of-two block dimensions, so the 192-wide gate axis is
split gate-major into three 64-wide blocks (z, r, n).

Precision: gates and carry are fp32 in both implementations; bf16 inputs
change only the operands of the input projection.  The scan's products run
at the encoder's ``MATMUL_PRECISION`` (HIGHEST); the kernel's at
``KERNEL_PRECISION`` (3xTF32), which agrees with the fp32 scan to 2.4e-6 at
B=8192 on the H100.

Gradients: ``gru_bi`` carries a custom_vjp with a manual backward
(``_bwd_manual``): gates are recomputed in parallel from the saved hidden
states (three batched matmuls), and the only sequential work is the
light cotangent recurrence, a ``lax.scan``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from deepreadmapper_tpu.ops.platform import use_kernels

H = 64
G = 3 * H

BT = 128         # batch rows per block: B=8192 gives 128 blocks for 132 SMs
NUM_WARPS = 8
# Kernel products: three TF32 passes (split operands), fp32-level accuracy
# on the tensor cores.  A plain fp32 product (Triton's IEEE path) runs on
# the FMA units and was 40x slower on the H100; one TF32 pass leaves
# ~7e-4 error.  The CPU interpreter has no TF32, so interpret mode runs
# fp32 at HIGHEST.
KERNEL_PRECISION = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


# ---------------------------------------------------------------- scan ref


def _scan_impl(gx, r_mat, rbh, reverse: bool, unroll: int = 1):
    """Differentiable reference: returns hs [T,B,64] in original positions."""
    b_ = gx.shape[1]
    h0 = jnp.zeros((b_, H), dtype=gx.dtype)

    def step(h, gxt):
        gh = h @ r_mat
        z = jax.nn.sigmoid(gxt[:, :H] + gh[:, :H])
        r = jax.nn.sigmoid(gxt[:, H : 2 * H] + gh[:, H : 2 * H])
        n = jnp.tanh(gxt[:, 2 * H :] + r * (gh[:, 2 * H :] + rbh))
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    _, hs = jax.lax.scan(step, h0, gx, reverse=reverse, unroll=unroll)
    return hs


def _scan_proj_impl(x, w, bzr, r_mat, rbh, reverse: bool, last_only: bool,
                    unroll: int = 1):
    """One direction: hoisted input projection + recurrence scan."""
    t_, b_, din = x.shape
    in_dt = x.dtype
    if in_dt == jnp.bfloat16:
        # the kernel's precision model: bf16 values, fp32 gate math and
        # carry (also what the custom_vjp backward differentiates)
        x = x.astype(jnp.float32)
        w = w.astype(jnp.float32)
        bzr = bzr.astype(jnp.float32)
        r_mat = r_mat.astype(jnp.float32)
        rbh = rbh.astype(jnp.float32)
    gx = (x.reshape(t_ * b_, din) @ w + bzr).reshape(t_, b_, G)
    hs = _scan_impl(gx, r_mat, rbh, reverse, unroll)
    if last_only:
        return hs[0] if reverse else hs[-1]  # fp32, like the kernel's hT
    return hs.astype(in_dt)  # per-step outputs match input dtype


def _scan_bi(x, w, bzr, r_mat, rbh, last_only: bool, unroll: int = 1):
    """Both directions with the scan; same outputs as the kernel."""
    outs = [
        _scan_proj_impl(x, w[d], bzr[d], r_mat[d], rbh[d], d == 1, last_only,
                        unroll)
        for d in (0, 1)
    ]
    return jnp.concatenate(outs, axis=-1)


# ------------------------------------------------------------ Triton kernel


def _gru_kernel(x_ref, w_ref, b_ref, r_ref, rbh_ref, o_ref, *, t_steps: int,
                last_only: bool, precision):
    """One (batch tile, direction) block; the whole sequence in one loop.

    x_ref [T, bt, din]; w_ref [1, 3, din, 64]; b_ref [1, 3, 64];
    r_ref [1, 3, 64, 64]; rbh_ref [1, 64]; o_ref [T, bt, 64] or [bt, 64]."""
    rev = pl.program_id(1) == 1
    bt = x_ref.shape[1]
    f32 = jnp.float32

    def proj(x, g):
        return jnp.dot(x, w_ref[0, g], preferred_element_type=f32,
                       precision=precision) + b_ref[0, g].astype(f32)[None, :]

    def rec(h, g):
        return jnp.dot(h, r_ref[0, g].astype(f32), preferred_element_type=f32,
                       precision=precision)

    def step(i, h):
        t = jnp.where(rev, t_steps - 1 - i, i)
        x = x_ref[t]  # [bt, din]
        z = jax.nn.sigmoid(proj(x, 0) + rec(h, 0))
        r = jax.nn.sigmoid(proj(x, 1) + rec(h, 1))
        n = jnp.tanh(
            proj(x, 2) + r * (rec(h, 2) + rbh_ref[0].astype(f32)[None, :])
        )
        hn = (1.0 - z) * n + z * h
        if not last_only:
            o_ref[t] = hn.astype(o_ref.dtype)
        return hn

    h = jax.lax.fori_loop(0, t_steps, step, jnp.zeros((bt, H), f32))
    if last_only:
        o_ref[...] = h


def _gate_major(a, lead: tuple[int, ...]):
    """[..., 192] -> [..., 3, 64] moved so the gate axis follows `lead`."""
    a = a.reshape(*a.shape[:-1], 3, H)
    return jnp.moveaxis(a, -2, len(lead))


@functools.partial(jax.jit, static_argnames=("last_only", "bt", "interpret"))
def gru_bi_kernel(x, w, bzr, r_mat, rbh, last_only: bool, bt: int = BT,
                  interpret: bool = False):
    """The Triton kernel for both directions of one layer.

    x [T,B,din] (fp32 or bf16); w [2,din,192], bzr [2,192], r_mat [2,64,192],
    rbh [2,64] -> [T,B,128] in x.dtype, or [B,128] fp32 when last_only."""
    t_steps, b, din = x.shape
    pad = (-b) % bt
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
    bp = b + pad
    w3 = _gate_major(w, (1,))                   # [2, 3, din, 64]
    r3 = _gate_major(r_mat, (1,))               # [2, 3, 64, 64]
    b3 = bzr.reshape(2, 3, H)                   # [2, 3, 64]
    if last_only:
        out_shape = jax.ShapeDtypeStruct((bp, 2 * H), jnp.float32)
        out_spec = pl.BlockSpec((bt, H), lambda i, d: (i, d))
    else:
        out_shape = jax.ShapeDtypeStruct((t_steps, bp, 2 * H), x.dtype)
        out_spec = pl.BlockSpec((t_steps, bt, H), lambda i, d: (0, i, d))
    out = pl.pallas_call(
        functools.partial(
            _gru_kernel, t_steps=t_steps, last_only=last_only,
            precision=(jax.lax.Precision.HIGHEST if interpret
                       else KERNEL_PRECISION),
        ),
        grid=(bp // bt, 2),
        in_specs=[
            pl.BlockSpec((t_steps, bt, din), lambda i, d: (0, i, 0)),
            pl.BlockSpec((1, 3, din, H), lambda i, d: (d, 0, 0, 0)),
            pl.BlockSpec((1, 3, H), lambda i, d: (d, 0, 0)),
            pl.BlockSpec((1, 3, H, H), lambda i, d: (d, 0, 0, 0)),
            pl.BlockSpec((1, H), lambda i, d: (d, 0)),
        ],
        out_specs=out_spec,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="gru_bi_seq" if not last_only else "gru_bi_last",
    )(x, w3.astype(x.dtype), b3, r3, rbh)
    if pad:
        out = out[:b] if last_only else out[:, :b]
    return out


# ------------------------------------------------------- manual backward
#
# Re-running the forward as a lax.scan under jax.vjp would recompute it
# sequentially and let XLA's autodiff scan carry the full gate state through
# device memory every step.  The manual VJP below makes the ONLY sequential
# work the cotangent recurrence (one [B,192]x[192,64] product + elementwise
# per step); everything heavy is hoisted into large products over all T
# steps at once:
#
#   recompute   gx = x@W, gh = h_prev@R        (z, r, n from saved states)
#   after scan  dx = dgx@W^T, dW = x^T dgx, dR = h_prev^T dgh
#
# Reverse-direction recurrences are handled by flipping time so one forward
# derivation serves both; weight grads are flip-invariant, dx flips back.


def _bwd_manual(x, w, bzr, r_mat, rbh, reverse, hs, ct_seq):
    in_dts = (x.dtype, w.dtype, bzr.dtype, r_mat.dtype, rbh.dtype)
    f32 = jnp.float32
    xf, wf, bzrf, rf, rbhf, hsf, ct = (
        a.astype(f32) for a in (x, w, bzr, r_mat, rbh, hs, ct_seq)
    )
    if reverse:
        # reverse recurrence on original time == forward recurrence on
        # flipped time (hs is stored in original positions by contract)
        xf, hsf, ct = jnp.flip(xf, 0), jnp.flip(hsf, 0), jnp.flip(ct, 0)
    t_, b_, din = xf.shape

    # -- parallel gate recompute (exact same op order as the forward step)
    gx = (xf.reshape(t_ * b_, din) @ wf + bzrf).reshape(t_, b_, G)
    h_prev = jnp.concatenate([jnp.zeros_like(hsf[:1]), hsf[:-1]], axis=0)
    gh = h_prev @ rf
    z = jax.nn.sigmoid(gx[..., :H] + gh[..., :H])
    r = jax.nn.sigmoid(gx[..., H : 2 * H] + gh[..., H : 2 * H])
    gnb = gh[..., 2 * H :] + rbhf  # the r-gated recurrent term of n
    n = jnp.tanh(gx[..., 2 * H :] + r * gnb)

    # -- sequential cotangent recurrence (the only scan)
    rT = rf.T

    def step(lam, inp):
        hp, z_, r_, n_, gnb_, ct_ = inp
        d = lam + ct_  # total cotangent on h_t
        dz = d * (hp - n_)
        dn = d * (1.0 - z_)
        dgn = dn * (1.0 - n_ * n_)
        dr = dgn * gnb_
        dghn = dgn * r_
        dgz = dz * z_ * (1.0 - z_)
        dgr = dr * r_ * (1.0 - r_)
        dgh = jnp.concatenate([dgz, dgr, dghn], axis=-1)
        lam_prev = d * z_ + dgh @ rT
        dgx = jnp.concatenate([dgz, dgr, dgn], axis=-1)
        return lam_prev, (dgx, dgh)

    lam0 = jnp.zeros((b_, H), f32)
    _, (dgx, dgh) = jax.lax.scan(
        step, lam0, (h_prev, z, r, n, gnb, ct), reverse=True
    )

    # -- parallel gradient contractions
    dgx2 = dgx.reshape(t_ * b_, G)
    dgh2 = dgh.reshape(t_ * b_, G)
    dx = (dgx2 @ wf.T).reshape(t_, b_, din)
    if reverse:
        dx = jnp.flip(dx, 0)
    dw = xf.reshape(t_ * b_, din).T @ dgx2
    dbzr = dgx2.sum(0)
    dr_mat = h_prev.reshape(t_ * b_, H).T @ dgh2
    drbh = dgh2[:, 2 * H :].sum(0)
    grads = (dx, dw, dbzr, dr_mat, drbh)
    return tuple(g.astype(dt) for g, dt in zip(grads, in_dts))


# ------------------------------------------------------------ entry point


def kernel_applies(dtype, platform: str | None = None) -> bool:
    """The GRU kernel runs where kernels run, for fp32 and bf16 inputs."""
    return use_kernels(platform) and dtype in (jnp.float32, jnp.bfloat16)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def gru_bi(x, w, bzr, r_mat, rbh, last_only: bool):
    """Both directions of one GRU layer, input projection fused.

    x [T,B,din] time-major; w [2,din,192], bzr [2,192], r_mat [2,64,192],
    rbh [2,64] -> [T,B,128] (forward || backward, original positions), or
    the final carries [B,128] when last_only."""
    if kernel_applies(x.dtype):
        return gru_bi_kernel(x, w, bzr, r_mat, rbh, last_only)
    return _scan_bi(x, w, bzr, r_mat, rbh, last_only)


def _gru_bi_fwd(x, w, bzr, r_mat, rbh, last_only):
    out = gru_bi(x, w, bzr, r_mat, rbh, last_only)
    # the seq output is its own residual; the last-only variant recomputes
    # the hidden states in the backward pass with the forward primal
    return out, (x, w, bzr, r_mat, rbh, None if last_only else out)


def _gru_bi_bwd(last_only, res, ct):
    x, w, bzr, r_mat, rbh, hs = res
    if hs is None:
        hs = gru_bi(x, w, bzr, r_mat, rbh, False)
    grads = []
    for d in (0, 1):
        hs_d = hs[..., d * H : (d + 1) * H]
        ct_d = ct[..., d * H : (d + 1) * H]
        if last_only:
            # hT cotangent -> a seq cotangent that is zero except at the
            # final step of the recurrence (T-1 forward, 0 reverse)
            pos = hs.shape[0] - 1 if d == 0 else 0
            ct_d = jnp.zeros(hs_d.shape, ct.dtype).at[pos].set(ct_d)
        grads.append(
            _bwd_manual(x, w[d], bzr[d], r_mat[d], rbh[d], d == 1, hs_d, ct_d)
        )
    (dx0, *g0), (dx1, *g1) = grads
    return (dx0 + dx1, *(jnp.stack([a, b]) for a, b in zip(g0, g1)))


gru_bi.defvjp(_gru_bi_fwd, _gru_bi_bwd)
