"""The port's structure metrics (``eval/metrics.py``: MSE, PSNR, SSIM)
against the JAX package's on the same inputs: seeded uint8 and float
images, one (H, W, C) and batched (B, H, W, C), identical images (PSNR
``inf``, SSIM 1), torch tensors as inputs, and hypothesis draws over
shapes from the window's 7 up and over values. Limits (f32 on both sides;
the sums' order differs): PSNR 1e-4 dB and SSIM 1e-5 of JAX's (measured:
1.7e-5 dB and 7e-7); MSE 1e-7 of the exact mean (float64) of the same f32
squared differences, and of JAX's value widened by JAX's own distance from
that exact mean: XLA's f32 sum strays up to 2.5e-7 from it at MSE 0.17 on
these inputs, while torch's lands within 1e-8."""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from image_editing_framework_torch.eval import metrics as port
from image_editing_framework_tpu.eval import metrics as ref

ATOL = {"mse": 1e-7, "psnr": 1e-4, "ssim": 1e-5}


def _exact_mse(a, b):
    a, b = (np.asarray(x, np.float32) / 255 if np.asarray(x).dtype == np.uint8 else np.asarray(x, np.float32)
            for x in (a, b))
    return float(((a - b) ** 2).astype(np.float64).mean())


def _close(a, b):
    for name, tol in ATOL.items():
        got, want = getattr(port, name)(a, b), getattr(ref, name)(np.asarray(a), np.asarray(b))
        assert isinstance(got, float)
        if name == "mse":
            exact = _exact_mse(a, b)
            assert abs(got - exact) <= tol, (got, exact)
            tol += abs(want - exact)
        assert got == want or abs(got - want) <= tol, (name, got, want)  # == for psnr's inf


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 24, 40, 3), (512, 512, 3)])
@pytest.mark.parametrize("kind", ["uint8", "float32", "float64"])
def test_metrics_equal_jax(shape, kind):
    rng = np.random.RandomState(sum(shape))
    a = rng.randint(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-40, 41, shape), 0, 255).astype(np.uint8)
    if kind != "uint8":
        a, b = (x.astype(kind) / 255.0 for x in (a, b))
    _close(a, b)
    _close(a, rng.permutation(b.reshape(-1)).reshape(shape))  # barely alike


def test_identical_images():
    a = np.random.RandomState(0).randint(0, 256, (16, 16, 3)).astype(np.uint8)
    assert port.mse(a, a) == ref.mse(a, a) == 0.0
    assert port.psnr(a, a) == ref.psnr(a, a) == math.inf
    assert abs(port.ssim(a, a) - 1.0) <= ATOL["ssim"] and abs(ref.ssim(a, a) - 1.0) <= ATOL["ssim"]


def test_tensor_inputs_on_the_cpu():
    """Tensors (the sweep hands numpy, but a caller may hold tensors) give
    the numpy inputs' values."""
    rng = np.random.RandomState(1)
    a, b = (rng.randint(0, 256, (20, 20, 3)).astype(np.uint8) for _ in range(2))
    for name in ATOL:
        assert getattr(port, name)(torch.from_numpy(a), torch.from_numpy(b)) == getattr(port, name)(a, b)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(7, 40), w=st.integers(7, 40), c=st.sampled_from([1, 3, 4]), seed=st.integers(0, 2**31 - 1),
       spread=st.integers(0, 255))
def test_metrics_equal_jax_on_drawn_shapes_and_values(h, w, c, seed, spread):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-spread, spread + 1, (h, w, c)), 0, 255).astype(np.uint8)
    _close(a, b)
