"""The port's LPIPS (``eval/lpips.py``) against the JAX package's, on the CPU
in float32, from one set of random torchvision-keyed VGG16 weights and
LPIPS heads (numpy, He-scaled so that the 13 layers stay live) given to both
``from_torch_files``: distances on uint8 and on [-1, 1] input at 32² and
64² within ``RTOL`` = 1e-5 relative, LPIPS(a, a) == 0 exactly, the path
form (one ``.safetensors`` file holding both state dicts), the port's own
state dict and its seeded random net. Two faults of the JAX runway are
recorded (ROADMAP C3): ``LPIPS("<path>")`` keeps the string as Flax params
and fails when called, and ``validate_pipeline`` calls it on unbatched
(H, W, 3) images, which its net cannot reduce."""

import numpy as np
import pytest
import torch

from image_editing_framework_torch.eval import lpips as tlpips
from image_editing_framework_torch.models.loader import save_safetensors
from image_editing_framework_tpu.eval import lpips as jlpips
from torch_port_helpers import chip_smoke

RTOL = 1e-5


@pytest.fixture(scope="module")
def torch_files():
    """(vgg_state, lin_state): torchvision's and LPIPS's keys, numpy f32."""
    rng = np.random.RandomState(0)
    vgg, cin = {}, 3
    for ch, idx in jlpips._VGG16_CONVS:
        vgg[f"features.{idx}.weight"] = (rng.randn(ch, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        vgg[f"features.{idx}.bias"] = (rng.randn(ch) * 0.01).astype(np.float32)
        cin = ch
    lin = {f"lin{i}.model.1.weight": np.abs(rng.randn(1, c, 1, 1) / np.sqrt(c)).astype(np.float32)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, lin


@pytest.fixture(scope="module")
def both(torch_files):
    return tlpips.LPIPS.from_torch_files(*torch_files, device="cpu"), jlpips.LPIPS.from_torch_files(*torch_files)


def test_layout_is_jaxs():
    assert tlpips._VGG16_CONVS == jlpips._VGG16_CONVS
    assert tlpips._TAPS == jlpips._TAPS and tlpips._POOL_AFTER == jlpips._POOL_AFTER
    np.testing.assert_array_equal(tlpips._SHIFT, jlpips._SHIFT)
    np.testing.assert_array_equal(tlpips._SCALE, jlpips._SCALE)
    taps = tlpips.VGG16Features()(torch.zeros(1, 3, 32, 32))
    assert [tuple(t.shape[1:]) for t in taps] == [(64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4), (512, 2, 2)]


@pytest.mark.parametrize("side", [32, 64])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_distances_match_jax(both, side, kind):
    port, ref = both
    rng = np.random.RandomState(side)
    a, b = (rng.randint(0, 256, (2, side, side, 3)).astype(np.uint8) for _ in range(2))
    if kind == "float":
        a, b = (x.astype(np.float32) / 127.5 - 1.0 for x in (a, b))
    got = port(a, b)
    want = ref(a, b)
    assert got > 0 and abs(got - want) <= RTOL * abs(want), (got, want)
    per_pair = port.distances(a, b)
    assert per_pair.shape == (2,) and per_pair.dtype == torch.float32
    for i in range(2):
        assert abs(float(per_pair[i]) - ref(a[i:i + 1], b[i:i + 1])) <= RTOL * float(per_pair[i])
    assert port(a, a) == 0.0
    assert port(b, a) == pytest.approx(got, rel=RTOL)


def test_the_path_form_reads_one_safetensors_file(torch_files, both, tmp_path):
    vgg, lin = torch_files
    path = str(tmp_path / "lpips.safetensors")
    save_safetensors({k: torch.from_numpy(v) for k, v in {**vgg, **lin}.items()}, path)
    from_path = tlpips.LPIPS(path, device="cpu")
    rng = np.random.RandomState(3)
    a, b = (rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8) for _ in range(2))
    assert from_path(a, b) == both[0](a, b)
    for key, value in both[0].net.state_dict().items():
        assert torch.equal(from_path.net.state_dict()[key], value), key


def test_the_ports_own_state_dict_and_the_random_net(both):
    port = both[0]
    again = tlpips.LPIPS(port.net.state_dict(), device="cpu")
    a = np.random.RandomState(4).randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    b = np.random.RandomState(5).randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    assert again(a, b) == port(a, b)
    r1, r2 = tlpips.LPIPS(device="cpu"), tlpips.LPIPS(None, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(r1.net.state_dict().values(), r2.net.state_dict().values()))
    assert all((r1.net.state_dict()[f"lin_{i}.weight"] >= 0).all() for i in range(5))
    assert r1(a, b) > 0 and r1(a, a) == 0.0
    with pytest.raises(KeyError):
        tlpips.LPIPS({}, device="cpu")


def test_chip_smokes_lpips_file_is_the_random_net(tmp_path):
    path = str(tmp_path / "lpips.safetensors")
    chip_smoke().write_lpips_weights(path)
    written, random = tlpips.LPIPS(path, device="cpu"), tlpips.LPIPS(device="cpu")
    for key, value in random.net.state_dict().items():
        assert torch.equal(written.net.state_dict()[key], value), key


def test_jax_lpips_fails_on_a_path_and_on_unbatched_images(torch_files, tmp_path):
    """ROADMAP C3: what JAX's runway and sweep hand to LPIPS."""
    a = np.random.RandomState(6).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    with pytest.raises(AttributeError, match="'str' object has no attribute 'items'"):  # kept as Flax params
        jlpips.LPIPS(str(tmp_path / "lpips.safetensors"))(a[None], a[None])
    with pytest.raises(IndexError):  # validate.py:218 passes (H, W, 3) images
        jlpips.LPIPS.from_torch_files(*torch_files)(a, a)
    port = tlpips.LPIPS.from_torch_files(*torch_files, device="cpu")
    assert port(a[None], a[None]) == 0.0
