"""Kernel selection: the one predicate every hand-written kernel follows.

The hand-written kernels (Pallas through Triton) exist for CUDA GPUs only.
On the CPU, which runs the tests, every hot path takes its plain XLA
formulation; a test that wants a kernel on the CPU calls it with
``interpret=True`` itself.  Any other platform is an error rather than a
silent fallback: nothing in this package was measured there.
"""

from __future__ import annotations

import jax

KERNEL_PLATFORMS = ("gpu",)
PLAIN_PLATFORMS = ("cpu",)


def use_kernels(platform: str | None = None) -> bool:
    """True where the Hopper kernels run (a CUDA GPU), False on the CPU.

    ``platform`` defaults to JAX's default backend; passing it explicitly
    lets callers and tests decide for a named platform without a device."""
    plat = platform or jax.default_backend()
    if plat in KERNEL_PLATFORMS:
        return True
    if plat in PLAIN_PLATFORMS:
        return False
    raise RuntimeError(
        f"no code path for platform {plat!r}: kernels run on "
        f"{KERNEL_PLATFORMS}, the plain XLA path on {PLAIN_PLATFORMS}"
    )
