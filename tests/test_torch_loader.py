"""The port's checkpoint reader and loader (``models/loader.py``): the reader
against ``safetensors.numpy`` / ``safetensors.torch`` for every dtype, BF16
included, sharded index files and unaligned offsets; ``load_params`` with the
JAX loader's contract (missing key -> KeyError, wrong shape -> ValueError,
extra key ignored), the fp16 -> bf16 cast, modules built on ``meta`` with no
random initialisation; ``load_weights`` stays strict."""

import gc
import json
import struct

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from image_editing_framework_torch.models import configs, registry, weights
from image_editing_framework_torch.models.clip import TINY_CLIP, CLIPTextModel
from image_editing_framework_torch.models.loader import (
    MmapSafetensors,
    export_params,
    load_params,
    load_safetensors,
    load_sharded_safetensors,
)
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.weights import load_weights, random_init_
from torch_port_helpers import chip_smoke

TORCH_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2,
                torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool]


def _sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    return torch.randint(-100 if dtype != torch.uint8 else 0, 100, shape, generator=g).to(dtype)


def _bits(t):
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


@pytest.mark.parametrize("dtype", TORCH_DTYPES, ids=str)
def test_reader_matches_safetensors_torch(tmp_path, dtype):
    tensors = {"w": _sample(dtype, (5, 3, 2), 0), "b": _sample(dtype, (7,), 1), "s": _sample(dtype, (), 2),
               "e": _sample(dtype, (0, 4), 3)}
    path = str(tmp_path / "x.safetensors")
    torch_save_file(tensors, path, metadata={"format": "pt"})
    got, want = load_safetensors(path), torch_load_file(path)
    assert set(got.keys()) == set(want) and got.metadata == {"format": "pt"} and len(got) == 4
    for key in want:
        assert got[key].dtype == want[key].dtype == dtype and got[key].shape == want[key].shape
        assert torch.equal(_bits(got[key]), _bits(want[key])), key


def test_reader_matches_safetensors_numpy_and_views_outlive_it(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"a.weight": rng.randn(64, 32).astype(np.float32), "a.bias": rng.randn(64).astype(np.float32),
              "b.weight": rng.randn(4, 4, 3, 3).astype(np.float16), "c.count": np.arange(10, dtype=np.int64)}
    path = str(tmp_path / "w.safetensors")
    np_save_file(arrays, path)
    reader = load_safetensors(path)
    views = dict(reader.items())
    want = np_load_file(path)
    del reader
    gc.collect()
    for key, value in want.items():
        np.testing.assert_array_equal(views[key].numpy(), value)
    # the map is private: writing a view leaves the file as it was
    views["a.bias"][0] = 1e9
    np.testing.assert_array_equal(np_load_file(path)["a.bias"], arrays["a.bias"])


def test_unaligned_offsets_are_copied(tmp_path):
    """A header length that leaves the data at an odd file offset, and an f32
    tensor after a 3-byte one: both come out right (copied, not viewed)."""
    a, b = np.arange(3, dtype=np.int8), np.arange(5, dtype=np.float32) / 3
    c = np.arange(6, dtype=np.float16).reshape(2, 3)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [5], "data_offsets": [3, 23]},
              "c": {"dtype": "F16", "shape": [2, 3], "data_offsets": [23, 35]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8 + 1)
    path = tmp_path / "unaligned.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + a.tobytes() + b.tobytes() + c.tobytes())
    want, got = np_load_file(str(path)), load_safetensors(str(path))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])
        assert got[key].data_ptr() % got[key].element_size() == 0


def test_damaged_headers_are_refused(tmp_path):
    header = {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}
    blob = json.dumps(header).encode()
    path = tmp_path / "short.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + bytes(12))
    with pytest.raises(ValueError, match="offsets"):
        MmapSafetensors(str(path))
    header = {"a": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}
    blob = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + bytes(8))
    with pytest.raises(ValueError, match="C64"):
        MmapSafetensors(str(path))


def test_sharded_index(tmp_path):
    part1 = {"x.weight": torch.randn(3, 2), "x.bias": torch.randn(3)}
    part2 = {"y.weight": torch.randn(2, 2).to(torch.bfloat16)}
    torch_save_file(part1, str(tmp_path / "model-00001-of-00002.safetensors"))
    torch_save_file(part2, str(tmp_path / "model-00002-of-00002.safetensors"))
    weight_map = {**{k: "model-00001-of-00002.safetensors" for k in part1},
                  **{k: "model-00002-of-00002.safetensors" for k in part2}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    got = load_sharded_safetensors(str(tmp_path), "model")
    assert set(got) == set(weight_map)
    for key, value in {**part1, **part2}.items():
        assert torch.equal(got[key], value)
    # a single file wins over the index
    torch_save_file(part2, str(tmp_path / "model.safetensors"))
    assert set(load_sharded_safetensors(str(tmp_path), "model").keys()) == set(part2)


def _tiny_clip_ckpt(tmp_path, dtype=torch.float16, extra=True):
    ref = random_init_(CLIPTextModel(TINY_CLIP), seed=3)
    state = dict(ref.state_dict())
    if extra:
        state.update(chip_smoke().clip_position_ids())
    path = str(tmp_path / "clip.safetensors")
    torch_save_file({k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}, path)
    return ref, path


def _meta_clip():
    with torch.device("meta"):
        return CLIPTextModel(TINY_CLIP)


def test_load_params_contract(tmp_path):
    ref, path = _tiny_clip_ckpt(tmp_path, torch.float32)
    ckpt = load_safetensors(path)
    module = load_params(_meta_clip(), ckpt)  # the extra position_ids ignored
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in module.parameters())
    for key, value in ref.state_dict().items():
        assert torch.equal(module.state_dict()[key], value), key
    assert export_params(module).keys() == ref.state_dict().keys()
    missing = {k: v for k, v in ckpt.items() if k != "text_model.final_layer_norm.bias"}
    with pytest.raises(KeyError, match="text_model.final_layer_norm.bias"):
        load_params(_meta_clip(), missing)
    wrong = dict(ckpt.items(), **{"text_model.final_layer_norm.weight": torch.zeros(5)})
    with pytest.raises(ValueError, match="text_model.final_layer_norm.weight"):
        load_params(_meta_clip(), wrong)
    with pytest.raises(KeyError, match="extra"):
        load_params(_meta_clip(), ckpt, strict=True)
    with pytest.raises(KeyError, match="extra"):  # load_weights stays strict
        load_weights(CLIPTextModel(TINY_CLIP), ckpt)
    # a materialised module is filled in place, on its own device and dtype
    target = CLIPTextModel(TINY_CLIP).to(torch.float64)
    assert load_params(target, ckpt) is target
    assert target.text_model.final_layer_norm.weight.dtype == torch.float64


def test_fp16_to_bf16_cast_matches_torch(tmp_path):
    _, path = _tiny_clip_ckpt(tmp_path, torch.float16)
    ckpt = load_safetensors(path)
    module = load_params(_meta_clip(), ckpt, torch.bfloat16, "cpu")
    for key, value in module.state_dict().items():
        assert value.dtype == torch.bfloat16
        assert torch.equal(value, ckpt[key].to(torch.bfloat16)), key


def test_registry_builds_on_meta_with_no_random_init(tmp_path, monkeypatch):
    """``registry._load`` hands ``load_params`` a module on the meta device and
    never calls the random initialiser."""
    unet = random_init_(UNet2DCondition(configs.TINY_UNET), seed=1)
    path = str(tmp_path / "unet.safetensors")
    torch_save_file(unet.state_dict(), path)
    seen = []
    real = registry.load_params

    def recording(module, ckpt, dtype=None, device=None, strict=False):
        seen.append(all(p.is_meta for p in module.parameters()))
        return real(module, ckpt, dtype, device, strict)

    def no_random_init(*args, **kwargs):
        raise AssertionError("random_init_ ran during a checkpoint load")

    monkeypatch.setattr(registry, "load_params", recording)
    monkeypatch.setattr(weights, "random_init_", no_random_init)
    loaded = registry._load(UNet2DCondition, configs.TINY_UNET, load_safetensors(path), torch.float32,
                            torch.device("cpu"))
    assert seen == [True]
    assert not any(p.requires_grad for p in loaded.parameters()) and not loaded.training
    for key, value in unet.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
