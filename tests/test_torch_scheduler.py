"""The port's DDIM scheduler against the JAX package's: tables exactly,
steps within atol 1e-6 (f32; the port computes its scalars on the host)."""

import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_torch.core import scheduler as tsch
from image_editing_framework_tpu.core import scheduler as jsch
from torch_port_helpers import n, t


@pytest.mark.parametrize("num_steps", [4, 50])
def test_schedule_tables_equal(num_steps):
    j, p = jsch.make_ddim_schedule(num_steps), tsch.make_ddim_schedule(num_steps)
    np.testing.assert_array_equal(n(p.alphas_cumprod), n(j.alphas_cumprod))
    assert n(p.alphas_cumprod).dtype == np.float32
    np.testing.assert_array_equal(n(p.final_alpha_cumprod), n(j.final_alpha_cumprod))
    np.testing.assert_array_equal(n(p.timesteps), n(j.timesteps))
    assert p.step_ratio == j.step_ratio
    for i in range(num_steps):
        assert tsch.inversion_timestep(p, i) == int(jsch.inversion_timestep(j, i))


@pytest.mark.parametrize("num_steps", [4, 50])
def test_ddim_steps_match(num_steps):
    j, p = jsch.make_ddim_schedule(num_steps), tsch.make_ddim_schedule(num_steps)
    rng = np.random.RandomState(num_steps)
    for i in range(num_steps):
        eps, x = (rng.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
        for jf, tf in ((jsch.ddim_step, tsch.ddim_step), (jsch.ddim_reverse_step, tsch.ddim_reverse_step)):
            ref = jf(j, jnp.asarray(eps), i, jnp.asarray(x))
            out = tf(p, t(eps), i, t(x))
            np.testing.assert_allclose(n(out), n(ref), atol=1e-6, rtol=0)


def test_reverse_step_inverts_step():
    """The inversion step and the denoising step are inverses for one eps."""
    p = tsch.make_ddim_schedule(10)
    rng = np.random.RandomState(0)
    eps, x = (t(rng.randn(1, 4, 4, 4).astype(np.float32)) for _ in range(2))
    for i in range(10):
        up = tsch.ddim_reverse_step(p, eps, i, x)
        back = tsch.ddim_step(p, eps, p.num_steps - 1 - i, up)
        np.testing.assert_allclose(n(back), n(x), atol=1e-5, rtol=0)


def test_scale_model_input_is_jaxs_identity():
    x = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    ref = jsch.scale_model_input(jnp.asarray(x), jnp.asarray(10))
    out = tsch.scale_model_input(t(x), 10)
    np.testing.assert_array_equal(n(out), np.asarray(ref))
