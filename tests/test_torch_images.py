"""The port's image IO (``utils/images.py``) against Pillow and the JAX
package's: its PNG reader on all five row filters and on Pillow's own files
(RGB and RGBA), its writer read back by Pillow, ``load_image`` giving the
JAX ``load_image``'s pixels (without Pillow for a PNG at the model's size,
through Pillow for a JPEG or a resize), and an ImportError naming the file
where Pillow is needed and missing; ``save_images`` against the JAX
function's files."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from image_editing_framework_torch.utils import images
from image_editing_framework_tpu.utils import images as jax_images


def _filtered_png(img, kinds):
    """An 8-bit PNG of ``img`` whose row y uses filter kinds[y % len(kinds)]
    (Pillow chooses its filters itself)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        kind, cur = kinds[y % len(kinds)], x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - upleft
        paeth = np.where((np.abs(p - left) <= np.abs(p - up)) & (np.abs(p - left) <= np.abs(p - upleft)), left,
                         np.where(np.abs(p - up) <= np.abs(p - upleft), up, upleft))
        pred = [np.zeros_like(cur), left, up, (left + up) // 2, paeth][kind]
        rows.append(np.concatenate([[kind], (cur - pred) & 0xFF]).astype(np.uint8))
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (images._SIGNATURE + images._chunk(b"IHDR", header)
            + images._chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())) + images._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4, 4, 3, 1]], ids=str)
def test_reader_undoes_every_filter(channels, kinds):
    img = np.random.RandomState(len(kinds) + channels).randint(0, 256, (23, 17, channels), np.uint8)
    data = _filtered_png(img, kinds)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)  # a valid PNG
    np.testing.assert_array_equal(images.decode_png(data), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_reader_and_writer_against_pillow(mode):
    img = np.random.RandomState(5).randint(0, 256, (40, 33, len(mode)), np.uint8)
    img[:20] = img[0:1]  # flat rows, where Pillow's encoder picks other filters
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    np.testing.assert_array_equal(images.decode_png(buf.getvalue()), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(images.encode_png(img)))), img)
    damaged = bytearray(buf.getvalue())
    damaged[40] ^= 0xFF
    with pytest.raises(ValueError):
        images.decode_png(bytes(damaged))


def test_other_pngs_are_left_to_pillow():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(buf, format="PNG")
    assert images.decode_png(buf.getvalue()) is None


def test_load_image_matches_jax(tmp_path):
    rgba = np.random.RandomState(2).randint(0, 256, (32, 48, 4), np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "a.png")
    Image.fromarray(rgba[:, :, :3]).save(tmp_path / "a.jpg", quality=90)
    for name, (h, w) in (("a.png", (32, 48)), ("a.png", (16, 16)), ("a.jpg", (32, 48)), ("a.jpg", (24, 20))):
        path = str(tmp_path / name)
        got, want = images.load_image(path, h, w), jax_images.load_image(path, h, w)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {h}x{w}")


def test_pillow_is_needed_only_for_jpeg_or_resize(tmp_path, monkeypatch):
    img = np.random.RandomState(3).randint(0, 256, (16, 16, 3), np.uint8)
    images.save_img(img, str(tmp_path / "x.png"))
    Image.fromarray(img).save(tmp_path / "x.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)  # as if Pillow were not installed
    np.testing.assert_array_equal(images.load_image(str(tmp_path / "x.png"), 16, 16), img)
    with pytest.raises(ImportError, match=r"x\.png: resizing it from 16x16 to 8x8 needs Pillow"):
        images.load_image(str(tmp_path / "x.png"), 8, 8)
    with pytest.raises(ImportError, match=r"x\.jpg: reading this image .* needs Pillow"):
        images.load_image(str(tmp_path / "x.jpg"), 16, 16)


def test_save_img_and_save_images_match_jax(tmp_path):
    batch = np.random.RandomState(4).randint(0, 256, (3, 8, 6, 3), np.uint8)
    images.save_img(batch[:1], str(tmp_path / "one.png"))  # a batch of one: its image
    assert sorted(os.listdir(tmp_path)) == ["one.png"]  # no .tmp left
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "one.png")), batch[0])
    with pytest.raises(ValueError):
        images.save_img(batch[0, 0], str(tmp_path / "bad.png"))
    for nrow, ncol in ((1, None), (2, 2), (1, 2)):
        mine, theirs = tmp_path / f"port{nrow}{ncol}", tmp_path / f"jax{nrow}{ncol}"
        images.save_images(batch, nrow, ncol, str(mine))
        jax_images.save_images(batch, nrow, ncol, str(theirs))
        assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
        for name in os.listdir(theirs):
            np.testing.assert_array_equal(np.asarray(Image.open(mine / name)), np.asarray(Image.open(theirs / name)),
                                          err_msg=name)
