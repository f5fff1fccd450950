"""The Hopper kernels as compiled for the card (no interpret mode) against
their plain references.  Marked ``gpu``: they skip on the CPU and run on a
card with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_gru_kernel_compiled_matches_scan(gpu_device):
    import jax
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import gru_pallas as gp

    rng = np.random.default_rng(0)
    t, b = 123, 512
    for din, last in ((64, False), (128, True)):
        x = jnp.asarray(rng.standard_normal((t, b, din)) * 0.5, jnp.float32)
        w = jnp.asarray(rng.standard_normal((2, din, gp.G)) * 0.2, jnp.float32)
        bzr = jnp.asarray(rng.standard_normal((2, gp.G)) * 0.1, jnp.float32)
        r = jnp.asarray(rng.standard_normal((2, gp.H, gp.G)) * 0.2,
                        jnp.float32)
        rbh = jnp.asarray(rng.standard_normal((2, gp.H)) * 0.1, jnp.float32)
        got = gp.gru_bi_kernel(x, w, bzr, r, rbh, last)
        with jax.default_matmul_precision("highest"):
            want = gp._scan_bi(x, w, bzr, r, rbh, last)
        # 3xTF32 kernel products against fp32 at HIGHEST
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-4)


def test_int8_winmin_kernel_compiled_matches_xla(gpu_device):
    import jax.numpy as jnp

    from deepreadmapper_tpu.ops import scan_kernel as sk

    rng = np.random.default_rng(1)
    r8 = jnp.asarray(rng.integers(-127, 128, (1 << 18, 128)), jnp.int8)
    q8 = jnp.asarray(rng.integers(-127, 128, (1024, 128)), jnp.int8)
    vk, ak = sk.winmin_kernel(q8, r8, (1 << 18) - 5, 2.0)
    vx, ax = sk.winmin_xla(q8, r8, (1 << 18) - 5, 2.0)
    np.testing.assert_array_equal(np.asarray(vk), np.asarray(vx))
    np.testing.assert_array_equal(np.asarray(ak), np.asarray(ax))
