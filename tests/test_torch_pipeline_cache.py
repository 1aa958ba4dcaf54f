"""The pipeline cache (``models/registry.py save_pipeline_cache`` /
``restore_pipeline_cache``) on the tiny pipelines, as the JAX package's
``test_orbax_pipeline_cache_roundtrip`` (tests/test_loader.py) holds its
own: save, zero the weights, restore, bitwise equal. The cache is one
``.safetensors`` file a module (JAX writes orbax directories), written by
the port's ``models/loader.py save_safetensors``, whose files the port's
``MmapSafetensors`` and the ``safetensors`` package both read back, in F32,
F16 and BF16."""

import os

import numpy as np
import pytest
import torch
from safetensors import safe_open

from image_editing_framework_torch.models import registry
from image_editing_framework_torch.models.loader import MmapSafetensors, save_safetensors
from image_editing_framework_torch.pipelines import tiny_pipeline


@pytest.mark.parametrize("model_type", ["sd", "xl"])
def test_pipeline_cache_round_trip(tmp_path, model_type):
    pipe = tiny_pipeline(num_steps=4, model_type=model_type, device="cpu")
    modules = {"unet": pipe.unet, "vae": pipe.vae, "text": pipe.text_encoder}
    if model_type == "xl":
        modules["text2"] = pipe.text_encoder_2
    orig = {name: {k: v.clone() for k, v in m.state_dict().items()} for name, m in modules.items()}
    cache = str(tmp_path / "cache")
    registry.save_pipeline_cache(pipe, cache)
    assert sorted(os.listdir(cache)) == sorted(f"{name}.safetensors" for name in modules)
    with torch.no_grad():
        for m in modules.values():
            for p in m.parameters():
                p.zero_()
    assert registry.restore_pipeline_cache(pipe, cache) is pipe
    for name, m in modules.items():
        for k, v in m.state_dict().items():
            assert v.dtype == orig[name][k].dtype
            assert torch.equal(v, orig[name][k]), (name, k)


def test_restore_skips_a_missing_second_tower_only(tmp_path):
    """A cache without ``text2`` leaves the second tower as it is (JAX
    restores text2 only where its directory exists); a missing first tower
    raises."""
    xl = tiny_pipeline(num_steps=4, model_type="xl", device="cpu")
    registry.save_pipeline_cache(xl, str(tmp_path))
    os.remove(tmp_path / "text2.safetensors")
    with torch.no_grad():
        for p in xl.text_encoder_2.parameters():
            p.fill_(0.5)
    registry.restore_pipeline_cache(xl, str(tmp_path))
    assert all(bool((p == 0.5).all()) for p in xl.text_encoder_2.parameters())
    os.remove(tmp_path / "text.safetensors")
    with pytest.raises(FileNotFoundError):
        registry.restore_pipeline_cache(xl, str(tmp_path))


@pytest.mark.parametrize("dtype,name", [(torch.float32, "F32"), (torch.float16, "F16"), (torch.bfloat16, "BF16")])
def test_writer_files_read_back_by_both_readers(tmp_path, dtype, name):
    gen = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=gen).to(dtype), "b": torch.randn(7, generator=gen).to(dtype),
               "c.t": torch.randn(4, 6, generator=gen).to(dtype).t(), "ids": torch.arange(5)}
    path = str(tmp_path / "x.safetensors")
    nbytes = save_safetensors(tensors, path)
    assert nbytes == sum(t.numel() * t.element_size() for t in tensors.values())
    ours = MmapSafetensors(path)
    assert ours.meta["a.weight"]["dtype"] == name and ours.meta["ids"]["dtype"] == "I64"
    assert list(ours.keys()) == list(tensors)
    with safe_open(path, framework="pt") as f:
        for key, ref in tensors.items():
            assert torch.equal(ours[key], ref) and ours[key].dtype == ref.dtype, key
            assert torch.equal(f.get_tensor(key), ref), key
    cast = str(tmp_path / "cast.safetensors")
    save_safetensors({"x": tensors["a.weight"].float()}, cast, dtype)
    np.testing.assert_array_equal(MmapSafetensors(cast)["x"].float().numpy(), tensors["a.weight"].float().numpy())
