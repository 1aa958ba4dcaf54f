"""The port's editing service (``serve.py``) on the tiny pipelines, on the
CPU: the counterparts of ``tests/test_serve.py`` (requests of every kind,
atomic intake, grouping of compatible requests, direct inversion in a group,
a config dict, XL kept serial), a bad group answered without crashing the
poll, ``main`` with ``run_forever`` patched out, and parity: one spool
served by both packages' services on one set of weights
(``shared_pipelines``, 4 steps, 32²) gives the same PNGs, ``source.png``
equal and ``inversion.png`` / ``edit.png`` within ``LEVELS`` = 1 uint8
level (``tests/test_batched.py``'s limit), for a spool of P2P, MasaCtrl and
PnP requests and for one of the gradient groups (a pix2pix-zero DDIM group
and a P2P null-text group; the JAX side's edits there without its Pallas
kernels, whose backward in interpret mode would take minutes). The synthesis requests' start
latents are injected in both packages: the port draws them from a torch
generator, JAX from its own PRNG, and the two streams differ by design.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_editing_framework_torch import cli as tcli
from image_editing_framework_torch import serve as tserve
from image_editing_framework_torch.core.config import P2PConfig
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.utils.images import decode_png
from image_editing_framework_tpu import serve as jserve
from image_editing_framework_tpu.eval import batched as jbatched
from torch_port_helpers import fix_vocab, shared_pipelines

LEVELS = 1
RES = 32


@pytest.fixture(scope="module")
def pipe():
    return tiny_pipeline(num_steps=4, device="cpu")


def _image(path, seed):
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (RES, RES, 3), np.uint8)).save(path)
    return str(path)


def _request(svc, name, **req):
    with open(os.path.join(svc.requests_dir, f"{name}.json"), "w") as f:
        json.dump(req, f)


def _response(svc, name):
    with open(os.path.join(svc.results_dir, name, "response.json")) as f:
        return json.load(f)


def test_service_handles_requests(pipe, tmp_path):
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    img = _image(tmp_path / "input.jpg", 0)
    _request(svc, "job1", method="masactrl", source_prompt="a cat", target_prompt="a standing cat", image_path=img,
             inversion_type="ddim")
    _request(svc, "job2", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", image_path=None, seed=7)
    _request(svc, "job3", method="nope", source_prompt="x", target_prompt="y")  # an error response, not a crash
    assert svc.poll_once() == 3
    assert svc.poll_once() == 0  # the spool is drained
    r1 = _response(svc, "job1")
    assert r1["status"] == "ok" and r1["latency_s"] > 0
    for f in ("source.png", "inversion.png", "edit.png"):
        assert os.path.exists(os.path.join(svc.results_dir, "job1", f))
    assert _response(svc, "job2")["status"] == "ok"
    assert os.path.exists(os.path.join(svc.results_dir, "job2", "edit.png"))
    r3 = _response(svc, "job3")
    assert r3["status"] == "error" and "nope" in r3["error"]
    assert os.listdir(svc.requests_dir) == []


def test_service_spool_intake_is_atomic(pipe, tmp_path):
    """A torn request is retried, then served once whole, never answered or
    deleted unparsed; one that stays unparseable is rejected after
    PARSE_RETRIES further polls with its bytes kept under rejected/, under a
    name of its own the second time."""
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    with open(os.path.join(svc.requests_dir, "slow.json.tmp"), "w") as f:
        f.write('{"method": "p2p", "source_prompt": "a cat sat",')
    assert svc.poll_once() == 0
    torn = os.path.join(svc.requests_dir, "slow.json")
    with open(torn, "w") as f:
        f.write('{"method": "p2p", "source_prompt": "a cat sat",')
    assert svc.poll_once() == 0
    assert os.path.exists(torn) and not os.path.exists(os.path.join(svc.results_dir, "slow", "response.json"))
    _request(svc, "slow", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", image_path=None, seed=1)
    assert svc.poll_once() == 1 and _response(svc, "slow")["status"] == "ok"

    bad = os.path.join(svc.requests_dir, "bad.json")
    with open(bad, "w") as f:
        f.write("{never json")
    for _ in range(svc.PARSE_RETRIES):
        assert svc.poll_once() == 0 and os.path.exists(bad)
    assert svc.poll_once() == 0 and not os.path.exists(bad)
    with open(os.path.join(svc.rejected_dir, "bad.json")) as f:
        assert f.read() == "{never json"
    assert _response(svc, "bad")["status"] == "error"
    with open(bad, "w") as f:
        f.write("{still not json")
    for _ in range(svc.PARSE_RETRIES + 1):
        svc.poll_once()
    with open(os.path.join(svc.rejected_dir, "bad.json")) as f:
        assert f.read() == "{never json"
    with open(os.path.join(svc.rejected_dir, "bad.1.json")) as f:
        assert f.read() == "{still not json"


def test_service_batches_compatible_requests(pipe, tmp_path, monkeypatch):
    """Compatible queued requests run as one batched edit; the odd one out
    runs alone in the same poll."""
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES, max_batch=4)
    groups = []
    real = tserve.batched.edit_batch
    monkeypatch.setattr(tserve.batched, "edit_batch", lambda *a, **k: groups.append(len(a[2])) or real(*a, **k))
    for i in range(3):
        _request(svc, f"syn{i}", method="p2p", source_prompt=f"a cat sat {i}", target_prompt=f"a dog sat {i}",
                 image_path=None, seed=i)
    _request(svc, "solo", method="masactrl", source_prompt="a cat", target_prompt="a standing cat", image_path=None)
    assert svc.poll_once() == 4
    assert svc.stats["batched"] == 3 and groups == [3]
    for i in range(3):
        r = _response(svc, f"syn{i}")
        assert r["status"] == "ok" and r["batched_with"] == 3
        assert os.path.exists(os.path.join(svc.results_dir, f"syn{i}", "edit.png"))
    solo = _response(svc, "solo")
    assert solo["status"] == "ok" and "batched_with" not in solo


def test_service_chunks_groups_by_max_batch(pipe, tmp_path):
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES, max_batch=2)
    for i in range(3):
        _request(svc, f"s{i}", method="pnp", source_prompt="a cat", target_prompt="a dog", image_path=None, seed=i)
    assert svc.poll_once() == 3
    assert sorted(_response(svc, f"s{i}").get("batched_with") for i in range(2)) == [2, 2]
    assert "batched_with" not in _response(svc, "s2")  # the chunk of one runs alone


def test_service_batches_direct_inversion(pipe, tmp_path):
    """Direct-inversion requests group too, each image replaying its own
    trajectory: the group gives each request's images as it alone."""
    root = tmp_path / "grouped"
    svc = tserve.EditService(pipe, str(root), resolution=RES, max_batch=4)
    for i in range(2):
        _request(svc, f"dir{i}", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat",
                 image_path=_image(tmp_path / f"in{i}.png", i + 1), inversion_type="direct")
    assert svc.poll_once() == 2 and svc.stats["batched"] == 2
    solo = tserve.EditService(pipe, str(tmp_path / "solo"), resolution=RES, max_batch=1)
    _request(solo, "dir1", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat",
             image_path=str(tmp_path / "in1.png"), inversion_type="direct")
    assert solo.poll_once() == 1
    for i in range(2):
        assert _response(svc, f"dir{i}")["status"] == "ok" and _response(svc, f"dir{i}")["batched_with"] == 2
    assert "batched_with" not in _response(solo, "dir1")
    for f in ("inversion.png", "edit.png"):
        a, b = (Image.open(os.path.join(s.results_dir, "dir1", f)) for s in (svc, solo))
        assert np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max() <= LEVELS


def test_service_parses_config_dict(pipe, tmp_path):
    """A JSON "config" sub-dict maps onto the method's config dataclass
    (lists become tuples), and such a request is not grouped."""
    kw = tserve._parse_method_kwargs("p2p", {"config": {"edit_type": "refine", "eq_words": ["big"],
                                                        "eq_values": [2.0]}})
    assert kw["config"] == P2PConfig(edit_type="refine", eq_words=("big",), eq_values=(2.0,))
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    req = dict(method="p2p", source_prompt="a cat", target_prompt="a big cat", image_path=None,
               method_kwargs={"config": {"edit_type": "refine", "cross_replace_steps": 0.7, "eq_words": ["big"],
                                         "eq_values": [2.0]}})
    assert svc._batch_key(req) is None
    _request(svc, "cfg", **req)
    assert svc.poll_once() == 1
    assert _response(svc, "cfg")["status"] == "ok", _response(svc, "cfg")
    assert os.path.exists(os.path.join(svc.results_dir, "cfg", "edit.png"))


def test_batch_keys(pipe, tmp_path):
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    real = dict(method="p2p", source_prompt="a", target_prompt="b", image_path="x.png")
    assert svc._batch_key(real) == ("p2p", True, "ddim")
    assert svc._batch_key(dict(real, inversion_type="null-text")) == ("p2p", True, "null-text")
    assert svc._batch_key(dict(real, inversion_type="other")) is None
    assert svc._batch_key(dict(real, image_path=None, inversion_type="direct")) == ("p2p", False, "")
    assert svc._batch_key(dict(real, method="nope")) is None
    assert tserve.EditService(pipe, str(tmp_path), resolution=RES, max_batch=1)._batch_key(real) is None


def test_a_failed_group_answers_every_request(pipe, tmp_path, monkeypatch):
    """A group whose batched edit raises gets an error response for each of
    its requests, with no retry one by one, and the poll goes on."""
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES, max_batch=4)
    calls = []

    def broken(*a, **k):
        calls.append(len(a[2]))
        raise RuntimeError("synthetic group failure")

    monkeypatch.setattr(tserve.batched, "edit_batch", broken)
    monkeypatch.setattr(tserve.cli, "run_method", lambda *a, **k: pytest.fail("retried one by one"))
    for i in range(2):
        _request(svc, f"g{i}", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", image_path=None,
                 seed=i)
    assert svc.poll_once() == 2 and calls == [2]
    for i in range(2):
        r = _response(svc, f"g{i}")
        assert r["status"] == "error" and "synthetic group failure" in r["error"]
    assert os.listdir(svc.requests_dir) == []


def test_a_failed_save_answers_an_error(pipe, tmp_path, monkeypatch):
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)

    def broken(img, path):
        raise OSError("synthetic save failure")

    monkeypatch.setattr(tserve, "save_img", broken)
    _request(svc, "s", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", image_path=None)
    assert svc.poll_once() == 1
    r = _response(svc, "s")
    assert r["status"] == "error" and "save failed" in r["error"]


def test_synthesis_latent_is_seeded_on_the_pipeline_device(pipe, tmp_path):
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    a, b = svc.synthesis_latent(7), svc.synthesis_latent(7)
    assert tuple(a.shape) == (1, RES // 8, RES // 8, 4) and a.device == pipe.device and a.dtype == pipe.dtype
    assert torch.equal(a, b) and not torch.equal(a, svc.synthesis_latent(8))


def test_service_keeps_xl_requests_serial(tmp_path):
    """An XL pipe serves every request alone (the batched editors are not
    grouped on XL, as in the JAX service)."""
    pipe = tiny_pipeline(num_steps=2, model_type="xl", device="cpu")
    svc = tserve.EditService(pipe, str(tmp_path), resolution=RES)
    img = _image(tmp_path / "input.png", 0)
    for j in range(2):
        _request(svc, f"job{j}", method="p2p", source_prompt="a cat sat", target_prompt="a dog sat",
                 image_path=img, inversion_type="ddim")
    assert svc.poll_once() == 2 and svc.stats["batched"] == 0
    for j in range(2):
        r = _response(svc, f"job{j}")
        assert r["status"] == "ok" and "batched_with" not in r, r


def test_main_loads_bf16_and_serves_the_root(pipe, tmp_path, monkeypatch):
    seen = {}

    def load_pipe(sd_version, dtype=torch.bfloat16, device=None):
        seen["load"] = (sd_version, dtype, device)
        return pipe

    monkeypatch.setattr(tcli, "load_pipe", load_pipe)
    monkeypatch.setattr(tserve.EditService, "run_forever", lambda self: seen.setdefault("root", self.root))
    tserve.main(["--sd_version", "2.1", "--root", str(tmp_path / "spool")])
    assert seen == {"load": ("2.1", torch.bfloat16, None), "root": str(tmp_path / "spool")}
    assert os.path.isdir(tmp_path / "spool" / "requests")


# ------------------------------------------------------------------ parity

SPOOL = [
    # two real-image P2P DDIM requests (replace and refine): one group
    ("p2p_a", dict(method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", inversion_type="ddim"), 1),
    ("p2p_b", dict(method="p2p", source_prompt="a cat sat", target_prompt="a fluffy cat sat"), 2),
    # two MasaCtrl synthesis requests: one group
    ("masa_a", dict(method="masactrl", source_prompt="a cat", target_prompt="a standing cat", seed=7), None),
    ("masa_b", dict(method="masactrl", source_prompt="a dog", target_prompt="a running dog", seed=8), None),
    # a PnP direct-inversion request alone
    ("pnp", dict(method="pnp", source_prompt="a cat", target_prompt="a dog", inversion_type="direct"), 3),
]


def _injected_latent(seed):
    return (np.random.RandomState(100 + seed).randn(1, RES // 8, RES // 8, 4)).astype(np.float32)


def test_both_services_give_the_same_pngs(tmp_path, monkeypatch):
    jpipe, tpipe = shared_pipelines(num_steps=4)
    fix_vocab((jpipe, tpipe), ["a cat sat dog fluffy standing running"])
    monkeypatch.setattr(jax.random, "PRNGKey", lambda seed: seed)
    monkeypatch.setattr(jax.random, "normal", lambda seed, shape, dtype: jnp.asarray(_injected_latent(seed), dtype))
    monkeypatch.setattr(tserve.EditService, "synthesis_latent",
                        lambda self, seed: torch.from_numpy(_injected_latent(seed)).to(self.pipe.dtype))
    services = {"jax": jserve.EditService(jpipe, str(tmp_path / "jax"), resolution=RES, max_batch=4),
                "port": tserve.EditService(tpipe, str(tmp_path / "port"), resolution=RES, max_batch=4)}
    for name, req, image_seed in SPOOL:
        image_path = None if image_seed is None else _image(tmp_path / f"{name}.png", image_seed)
        for svc in services.values():
            _request(svc, name, image_path=image_path, **req)
    for svc in services.values():
        assert svc.poll_once() == len(SPOOL)
    assert services["jax"].stats == services["port"].stats == {"handled": 5, "batched": 4}
    for name, _, image_seed in SPOOL:
        rj, rt = (_response(svc, name) for svc in services.values())
        assert rj["status"] == rt["status"] == "ok" and rj.get("batched_with") == rt.get("batched_with")
        files = ("source", "inversion", "edit") if image_seed is not None else ("inversion", "edit")
        for f in files:
            a, b = (decode_png(open(os.path.join(svc.results_dir, name, f + ".png"), "rb").read()).astype(np.int32)
                    for svc in services.values())
            # a synthesis latent is res // 8 wide in both services: 8² images from the tiny VAE
            assert a.shape == b.shape == ((RES, RES, 3) if image_seed is not None else (8, 8, 3)) and b.std() > 0
            assert np.abs(a - b).max() <= (0 if f == "source" else LEVELS), (name, f, np.abs(a - b).max())


# two gradient groups: pix2pix-zero on DDIM inversions, P2P on null-text
# inversions (each image's NTI run on its own, ``nti_group_serial``)
GRAD_SPOOL = [
    ("p2z_a", dict(method="p2z", source_prompt="a cat sat", target_prompt="a dog sat", inversion_type="ddim"), 4),
    ("p2z_b", dict(method="p2z", source_prompt="a dog sat", target_prompt="a cat sat", inversion_type="ddim"), 5),
    ("nti_a", dict(method="p2p", source_prompt="a cat sat", target_prompt="a dog sat", inversion_type="null-text"),
     6),
    ("nti_b", dict(method="p2p", source_prompt="a cat sat", target_prompt="a fluffy cat sat",
                   inversion_type="null-text"), 7),
]


def test_both_services_give_the_same_pngs_for_the_gradient_groups(tmp_path, monkeypatch):
    jpipe, tpipe = shared_pipelines(num_steps=4)
    fix_vocab((jpipe, tpipe), ["a cat sat dog fluffy"])
    for name in ("ddim_invert_batch", "nti_group_serial", "edit_batch"):
        monkeypatch.setattr(jbatched, name, functools.partial(getattr(jbatched, name), use_flash=False))
    services = {"jax": jserve.EditService(jpipe, str(tmp_path / "jax"), resolution=RES, max_batch=4),
                "port": tserve.EditService(tpipe, str(tmp_path / "port"), resolution=RES, max_batch=4)}
    for name, req, image_seed in GRAD_SPOOL:
        image_path = _image(tmp_path / f"{name}.png", image_seed)
        for svc in services.values():
            _request(svc, name, image_path=image_path, **req)
    for svc in services.values():
        assert svc.poll_once() == len(GRAD_SPOOL)
    assert services["jax"].stats == services["port"].stats == {"handled": 4, "batched": 4}
    for name, _, _ in GRAD_SPOOL:
        rj, rt = (_response(svc, name) for svc in services.values())
        assert rj["status"] == rt["status"] == "ok" and rj.get("batched_with") == rt.get("batched_with") == 2, (rj, rt)
        for f in ("source", "inversion", "edit"):
            a, b = (decode_png(open(os.path.join(svc.results_dir, name, f + ".png"), "rb").read()).astype(np.int32)
                    for svc in services.values())
            assert a.shape == b.shape == (RES, RES, 3) and b.std() > 0
            assert np.abs(a - b).max() <= (0 if f == "source" else LEVELS), (name, f, np.abs(a - b).max())
