"""The port's PIE-Bench data (``data/pie.py``) against the JAX package's on
the mini PIE of ``tests/test_sweep.py``: the items, the category filter, the
bracket stripping and ``shard`` equal; the inversion cache read across
packages in both directions (f32 ``.npz``, NHWC: arrays equal bit for bit);
the reference's ``.pt`` layout; a bf16 cache from before the producer stored
f32 (raw ``V2`` bytes) decoded without ``ml_dtypes``, equal to JAX's
``_denpz``; the same error messages for an incomplete cache and a missing
artifact; completeness narrowed to the work list."""

import os
import shutil
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from image_editing_framework_torch.data import pie as tpie
from image_editing_framework_tpu.data import pie as jpie
from test_sweep import mini_pie  # noqa: F401  (the JAX tests' mini PIE fixture)


@pytest.mark.parametrize("category", [None, 0, 6, 5])
def test_items_equal_jax(mini_pie, category):  # noqa: F811
    port, ref = tpie.PIE(mini_pie, category), jpie.PIE(mini_pie, category)
    assert len(port) == len(ref) == {None: 4, 0: 3, 6: 1, 5: 0}[category]
    assert [vars(it) for it in port.items] == [vars(it) for it in ref.items]
    for it in port.items:
        assert "[" not in it.source_prompt + it.target_prompt and os.path.exists(it.image_path)
    for index, count in ((0, 2), (1, 2), (2, 3), (0, 1)):
        assert port.shard(index, count) == [tpie.PIEItem(**vars(it)) for it in ref.shard(index, count)]
    assert tpie.DEFAULT_CATEGORIES == jpie.DEFAULT_CATEGORIES and 5 not in tpie.DEFAULT_CATEGORIES


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(1, 8, 8, 4).astype(np.float32), rng.randn(4, 77, 32).astype(np.float32)


def test_cache_written_by_jax_is_read_by_the_port(mini_pie, tmp_path):  # noqa: F811
    inv = str(tmp_path / "inv")
    items = jpie.PIE(mini_pie, 0).items
    for i, item in enumerate(items):
        lat, unc = _arrays(i)
        jpie.save_inversion(inv, item.key, jnp.asarray(lat), jnp.asarray(unc) if i else None)
    ds = tpie.PIEPrecomputedInversion(mini_pie, inv, category=0)
    for i, item in enumerate(ds.items):
        latent, uncond = ds.load_inversion(item)
        want = jpie.PIEPrecomputedInversion(mini_pie, inv, category=0).load_inversion(jpie.PIEItem(**vars(item)))
        assert latent.dtype == np.float32 and latent.shape == (1, 8, 8, 4)
        np.testing.assert_array_equal(latent, want[0])
        np.testing.assert_array_equal(latent, _arrays(i)[0])
        if i:
            np.testing.assert_array_equal(uncond, want[1])
        else:
            assert uncond is None and want[1] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_written_by_the_port_is_read_by_jax(mini_pie, tmp_path, dtype):  # noqa: F811
    """The port's producer takes its pipeline's tensors (bf16 on the card)
    and stores f32, NHWC, as JAX's does."""
    inv = str(tmp_path / "inv")
    items = tpie.PIE(mini_pie, 0).items
    for i, item in enumerate(items):
        lat, unc = _arrays(i)
        tpie.save_inversion(inv, item.key, torch.from_numpy(lat).to(dtype), torch.from_numpy(unc).to(dtype))
    ref = jpie.PIEPrecomputedInversion(mini_pie, inv, category=0)
    for i, item in enumerate(ref.items):
        latent, uncond = ref.load_inversion(item)
        lat, unc = _arrays(i)
        assert latent.dtype == uncond.dtype == np.float32
        np.testing.assert_array_equal(latent, torch.from_numpy(lat).to(dtype).float().numpy())
        np.testing.assert_array_equal(uncond, torch.from_numpy(unc).to(dtype).float().numpy())
        assert jnp.asarray(latent, jnp.bfloat16).dtype == jnp.bfloat16  # the JAX consumer's cast


def test_reference_pt_layout(mini_pie, tmp_path):  # noqa: F811
    """The reference's NCHW ``inversion_latent.pt`` and per-step list
    ``uncond_embeddings_list.pt`` come back NHWC / stacked, as from JAX's
    reader; the ``.npz`` wins where both exist."""
    inv = str(tmp_path / "inv_pt")
    rng = np.random.RandomState(7)
    lat_nchw = rng.randn(1, 4, 8, 8).astype(np.float32)
    ulist = [torch.from_numpy(rng.randn(1, 77, 32).astype(np.float32)) for _ in range(4)]
    for item in tpie.PIE(mini_pie).items:
        d = os.path.join(inv, item.key)
        os.makedirs(d)
        torch.save(torch.from_numpy(lat_nchw), os.path.join(d, "inversion_latent.pt"))
        torch.save(ulist, os.path.join(d, "uncond_embeddings_list.pt"))
    port, ref = tpie.PIEPrecomputedInversion(mini_pie, inv), jpie.PIEPrecomputedInversion(mini_pie, inv)
    latent, uncond = port.load_inversion(port[0])
    want = ref.load_inversion(ref[0])
    np.testing.assert_array_equal(latent, want[0])
    np.testing.assert_array_equal(latent, np.transpose(lat_nchw, (0, 2, 3, 1)))
    np.testing.assert_array_equal(uncond, want[1])
    assert uncond.shape == (4, 77, 32)
    os.remove(os.path.join(inv, port[1].key, "uncond_embeddings_list.pt"))
    assert port.load_inversion(port[1])[1] is None and ref.load_inversion(ref[1])[1] is None
    tpie.save_inversion(inv, port[2].key, np.zeros((1, 8, 8, 4)))
    np.testing.assert_array_equal(port.load_inversion(port[2])[0], 0)


def test_raw_bf16_cache_decodes_without_ml_dtypes(mini_pie, tmp_path, monkeypatch):  # noqa: F811
    """A cache written by a bf16 pipeline before the producer stored f32:
    ``np.savez`` kept bfloat16 as raw ``V2`` bytes. The port widens the bits
    itself (the card machine has no ``ml_dtypes``): equal to JAX's
    ``_denpz``, for normal, tiny, huge, signed-zero, inf and nan values."""
    inv = str(tmp_path / "inv")
    items = jpie.PIE(mini_pie, 0).items
    values = np.array([1.5, -2.5, 0.0, -0.0, 1e-40, 3e38, np.inf, -np.inf, np.nan, 0.1], np.float32)
    lat = np.resize(values, (1, 4, 4, 4)).astype(ml_dtypes.bfloat16)
    unc = np.random.RandomState(0).randn(2, 77, 8).astype(ml_dtypes.bfloat16)
    for item in items:
        os.makedirs(os.path.join(inv, item.key))
        np.savez(os.path.join(inv, item.key, "inversion.npz"), latent=lat, uncond_seq=unc)
    with np.load(os.path.join(inv, items[0].key, "inversion.npz")) as raw:
        assert raw["latent"].dtype == np.dtype("V2")
        want_lat, want_unc = jpie._denpz(raw["latent"]), jpie._denpz(raw["uncond_seq"])
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # any import of it now fails
    ds = tpie.PIEPrecomputedInversion(mini_pie, inv, category=0)
    latent, uncond = ds.load_inversion(ds[0])
    assert latent.dtype == uncond.dtype == np.float32
    np.testing.assert_array_equal(latent, want_lat)  # nan where nan, bit for bit elsewhere
    np.testing.assert_array_equal(latent.view(np.uint32)[~np.isnan(latent)],
                                  want_lat.view(np.uint32)[~np.isnan(want_lat)])
    np.testing.assert_array_equal(uncond, want_unc)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is what is compared
        return type(e), str(e)
    raise AssertionError("no error")


def test_error_messages_equal_jax(mini_pie, tmp_path):  # noqa: F811
    inv = str(tmp_path / "inv")
    for item in jpie.PIE(mini_pie, 0).items:
        jpie.save_inversion(inv, item.key, np.zeros((1, 4, 4, 4), np.float32))
    # incomplete: category 6's item has no artifact
    port = _error(lambda: tpie.PIEPrecomputedInversion(mini_pie, inv))
    assert port == _error(lambda: jpie.PIEPrecomputedInversion(mini_pie, inv))
    assert port[0] is ValueError and "not complete" in port[1] and "6_other/img" in port[1]
    both = _error(lambda: tpie.PIEPrecomputedInversion(mini_pie, inv, category=0,
                                                       required_items=tpie.PIE(mini_pie, 0).items))
    assert both[0] is ValueError and "not both" in both[1]
    # an artifact removed after the check
    ds, ref = tpie.PIEPrecomputedInversion(mini_pie, inv, category=0), jpie.PIEPrecomputedInversion(mini_pie, inv,
                                                                                                    category=0)
    shutil.rmtree(os.path.join(inv, ds[0].key))
    port = _error(lambda: ds.load_inversion(ds[0]))
    assert port == _error(lambda: ref.load_inversion(ref[0]))
    assert port[0] is FileNotFoundError and ds[0].key in port[1]


def test_completeness_narrowed_to_the_work_list(mini_pie, tmp_path):  # noqa: F811
    """A cache for category 0 only is complete for a work list in category
    0 and incomplete for one that holds category 6's item."""
    inv = str(tmp_path / "inv")
    for item in tpie.PIE(mini_pie, 0).items:
        tpie.save_inversion(inv, item.key, torch.zeros(1, 4, 4, 4))
    work = tpie.PIE(mini_pie, 0).items[1:]
    ds = tpie.PIEPrecomputedInversion(mini_pie, inv, required_items=work)
    assert ds.items == work and ds.data_path == os.path.join(mini_pie, "annotation_images")
    other = tpie.PIE(mini_pie, 6).items
    with pytest.raises(ValueError, match="not complete"):
        tpie.PIEPrecomputedInversion(mini_pie, inv, required_items=work + other)
    with pytest.raises(ValueError, match="not complete"):
        jpie.PIEPrecomputedInversion(mini_pie, inv, required_items=[jpie.PIEItem(**vars(it)) for it in other])
