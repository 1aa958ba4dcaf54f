"""The port's seeding rule (``core/rng.py``): a generator per seed, the
per-image stream a generator seeded with a fixed 64-bit hash of (seed,
index). Deterministic (the same pair gives the same stream, in this process
and in a fresh one), distinct (neighbouring seeds and indices give unrelated
seeds and streams, and image 1 of seed 0 is not image 0 of seed 1), NHWC
latents of the asked shape and dtype. The streams are not JAX's (``fold_in``
has no torch counterpart), so nothing here compares them with JAX."""

import subprocess
import sys

import pytest
import torch

from image_editing_framework_torch.core import rng


def test_per_image_streams_are_deterministic():
    a = rng.latents_like(rng.per_image_generator(42, 3, device="cpu"), 1, 8, 8)
    b = rng.latents_like(rng.per_image_generator(42, 3, device="cpu"), 1, 8, 8)
    assert torch.equal(a, b) and a.shape == (1, 8, 8, 4) and a.dtype == torch.float32
    code = ("from image_editing_framework_torch.core import rng\n"
            "print(rng.per_image_seed(42, 3), rng.latents_like(rng.per_image_generator(42, 3, 'cpu'), 1, 8, 8)"
            ".sum().item())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout.split()
    assert int(out[0]) == rng.per_image_seed(42, 3) and float(out[1]) == a.sum().item()


def test_per_image_streams_are_distinct():
    seeds = {(s, i): rng.per_image_seed(s, i) for s in range(-2, 40) for i in range(40)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(0 <= v < 2**64 for v in seeds.values())
    assert rng.per_image_seed(0, 1) != rng.per_image_seed(1, 0)  # not seed + index
    draws = [rng.latents_like(rng.per_image_generator(s, i, "cpu"), 1, 4, 4) for s, i in ((0, 0), (0, 1), (1, 0))]
    for x in draws[1:]:
        assert not torch.equal(draws[0], x)
        assert abs(torch.corrcoef(torch.stack([draws[0].reshape(-1), x.reshape(-1)]))[0, 1]) < 0.6
    # the per-image stream is not the seed's own stream
    assert not torch.equal(draws[0], rng.latents_like(rng.generator_from_seed(0, "cpu"), 1, 4, 4))


def test_generator_and_latents():
    gen = rng.generator_from_seed(7, "cpu")
    x = rng.latents_like(gen, 2, 3, 5, c=6, dtype=torch.float64)
    assert x.shape == (2, 3, 5, 6) and x.dtype == torch.float64
    assert torch.equal(x, torch.randn((2, 3, 5, 6), generator=torch.Generator().manual_seed(7), dtype=torch.float64))


def test_the_card_by_default():
    """Without ``device``, the generators are made on the card; where none
    is present they refuse."""
    if torch.cuda.is_available():
        assert rng.generator_from_seed(0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rng.generator_from_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rng.per_image_generator(0, 1)
