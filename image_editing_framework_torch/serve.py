"""Editing service: a long-lived worker that loads the pipeline once.

Counterpart of ``image_editing_framework_tpu/serve.py``. The reference ships
one-shot scripts that load the model on every call; this worker loads the
pipeline once and answers a spool of requests, grouping compatible ones into
one batched edit per poll (``eval/batched.py``).

Transport is a filesystem spool: drop ``<name>.json`` request files into
``<root>/requests/``; results appear under ``<root>/results/<name>/`` with a
``response.json`` and the output PNGs.

Intake is atomic-write friendly: writers should write to a temp name (a
leading dot or any non-``.json`` suffix, e.g. ``.json.tmp``) and ``rename``
into place; the poller only picks up ``*.json``. A half-written file that
does slip in (a torn write from a client that does not rename) is not
dropped: parse failures are retried for ``PARSE_RETRIES`` polls and only
then answered with an error, the original bytes kept under
``<root>/rejected/`` under a name of their own. A request is never deleted
unparsed.

Request schema:
  {"method": "p2p" | "masactrl" | "pnp" | "p2z",
   "source_prompt": str, "target_prompt": str,
   "image_path": str | null,        # null => synthesize from seed
   "inversion_type": "ddim" | "null-text" | "direct",   # default ddim
   "seed": int,                      # default 42
   "method_kwargs": {...}}           # optional method overrides; a "config"
                                     # sub-dict maps onto the method's config
                                     # dataclass (e.g. {"edit_type": "refine"})

Only the polling thread touches the card. Worker threads decode the
requests' images (prefetched for the whole poll before the first group
runs), encode the output PNGs, and write the responses and remove the
request files, so that one group's saves overlap the next group's edit.
A synthesis request's start latent is ``torch.randn`` from
``torch.Generator(device).manual_seed(seed)`` on the pipeline's device, as
the ``edit_syn`` entry point draws it: JAX's PRNG stream cannot be
reproduced in torch, so a seed gives another image than in the JAX package.

Run on the card:  python -m image_editing_framework_torch.serve --sd_version 1.5 --root ./service
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from image_editing_framework_torch import cli
from image_editing_framework_torch.core import config as cfgs
from image_editing_framework_torch.core.config import SamplerConfig
from image_editing_framework_torch.eval import batched
from image_editing_framework_torch.eval.sweep import _auto_p2p_config
from image_editing_framework_torch.utils.images import load_image, save_img

_CONFIGS = {"p2p": cfgs.P2PConfig, "masactrl": cfgs.MasaCtrlConfig, "pnp": cfgs.PnPConfig, "p2z": cfgs.P2ZConfig}


def _parse_method_kwargs(method: str, raw) -> dict:
    """JSON method_kwargs -> editor kwargs: a "config" sub-dict maps onto the
    method's config dataclass (JSON lists become the tuples the frozen
    dataclasses expect)."""
    kw = dict(raw or {})
    cfg = kw.get("config")
    if isinstance(cfg, dict):
        def tup(v):
            return tuple(tup(x) for x in v) if isinstance(v, list) else v

        kw["config"] = _CONFIGS[method](**{k: tup(v) for k, v in cfg.items()})
    return kw


def _error(e: Exception, prefix: str = "") -> dict:
    return {"status": "error", "error": f"{prefix}{type(e).__name__}: {e}", "traceback": traceback.format_exc()}


class EditService:
    """``max_batch`` > 1 groups compatible queued requests (same method and
    inversion type, default hyperparameters, SD family) into one batched
    edit per poll, so that a bursty queue runs at the group's throughput
    instead of one request at a time."""

    #: polls a torn request file gets to finish being written before it is
    #: rejected (writers that rename() into place never hit this path)
    PARSE_RETRIES = 3

    def __init__(self, pipe, root: str, resolution: Optional[int] = None, max_batch: int = 4):
        self.pipe = pipe
        self.root = root
        self.res = resolution or (1024 if pipe.model_type == "xl" else 512)
        self.max_batch = max_batch
        self.requests_dir = os.path.join(root, "requests")
        self.results_dir = os.path.join(root, "results")
        self.rejected_dir = os.path.join(root, "rejected")
        os.makedirs(self.requests_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        self.stats = {"handled": 0, "batched": 0}
        self._parse_failures: dict = {}  # fname -> failed poll count
        # PNG decodes and encodes; a separate single worker writes the
        # responses (it waits on save futures, which queued behind it on the
        # same pool could deadlock)
        self._io_pool = ThreadPoolExecutor(max_workers=4)
        self._finalize_pool = ThreadPoolExecutor(max_workers=1)

    def synthesis_latent(self, seed: int) -> torch.Tensor:
        """A synthesis request's (1, h, w, 4) start latent on the card."""
        gen = torch.Generator(device=self.pipe.device).manual_seed(seed)
        side = self.res // 8
        return torch.randn((1, side, side, 4), generator=gen, device=self.pipe.device).to(self.pipe.dtype)

    def _image(self, req: dict, image_future=None) -> np.ndarray:
        return image_future.result() if image_future is not None else load_image(req["image_path"], self.res,
                                                                                   self.res)

    def _saver(self, saves):
        """save(img, path): at once without ``saves``, else on the IO pool,
        its future appended to ``saves``."""
        def save(img, path):
            if saves is None:
                save_img(img, path)
            else:
                saves.append(self._io_pool.submit(save_img, img, path))
        return save

    def handle(self, name: str, req: dict, image_future=None, saves: Optional[list] = None) -> dict:
        """Serve one request. ``image_future`` (optional) is a prefetched PNG
        decode; ``saves`` (optional) collects the save futures, and then the
        caller waits for them before answering. Without them the call is
        synchronous."""
        save = self._saver(saves)
        t0 = time.perf_counter()
        method = req["method"]
        prompts = [req["source_prompt"], req["target_prompt"]]
        seed = int(req.get("seed", 42))
        inversion_type = req.get("inversion_type", "ddim")
        sampler = SamplerConfig(height=self.res, width=self.res, seed=seed)
        out_dir = os.path.join(self.results_dir, name)
        os.makedirs(out_dir, exist_ok=True)

        method_kwargs = _parse_method_kwargs(method, req.get("method_kwargs"))
        if method == "p2p" and "config" not in method_kwargs:
            # replace or refine by word count (p2p/test.py:120-123), the
            # batched path's default, so that a request edits alike whether
            # or not it was grouped
            method_kwargs["config"] = _auto_p2p_config(*prompts)

        replay = uncond_seq = None
        if req.get("image_path"):
            image = self._image(req, image_future)
            save(image, os.path.join(out_dir, "source.png"))
            latent, traj, uncond_seq = cli.invert(self.pipe, image, prompts[0], inversion_type, method)
            if inversion_type == "direct":
                replay = traj
        else:
            latent = self.synthesis_latent(seed)
        inv_img, edit_img = cli.run_method(method, self.pipe, prompts, latent, sampler, uncond_seq, method_kwargs,
                                           source_replay=replay)
        save(inv_img, os.path.join(out_dir, "inversion.png"))
        save(edit_img, os.path.join(out_dir, "edit.png"))
        return {"status": "ok", "outputs": out_dir, "latency_s": round(time.perf_counter() - t0, 3)}

    # ------------------------------------------------------------- batching

    def _batch_key(self, req: dict) -> Optional[tuple]:
        """Grouping key for the batched editors, or None when the request
        takes the serial path (XL pipes, custom hyperparameters, no
        grouping)."""
        if self.pipe.model_type != "sd" or self.max_batch < 2:
            return None
        if req.get("method") not in _CONFIGS:
            return None
        if req.get("method_kwargs"):
            return None
        if not req.get("image_path"):
            # synthesis requests never invert: no group splits on a field
            # the flow ignores
            return (req["method"], False, "")
        inversion = req.get("inversion_type", "ddim")
        if inversion not in cli.INVERSION_TYPES:
            return None
        return (req["method"], True, inversion)

    def handle_batch(self, names, reqs, image_futures=None, saves: Optional[dict] = None) -> dict:
        """One batched edit for a group of compatible requests.
        ``image_futures`` maps request name -> prefetched PNG decode;
        ``saves`` maps name -> list of save futures (see ``handle``)."""
        t0 = time.perf_counter()
        method = reqs[0]["method"]
        inversion = reqs[0].get("inversion_type", "ddim")
        pairs = [[r["source_prompt"], r["target_prompt"]] for r in reqs]
        out_dirs = [os.path.join(self.results_dir, n) for n in names]
        for d in out_dirs:
            os.makedirs(d, exist_ok=True)
        savers = {n: self._saver(None if saves is None else saves.setdefault(n, [])) for n in names}

        uncond_seqs = source_replays = None
        if reqs[0].get("image_path"):
            lats = []
            for n, r, d in zip(names, reqs, out_dirs):
                image = self._image(r, (image_futures or {}).get(n))
                savers[n](image, os.path.join(d, "source.png"))
                lats.append(self.pipe.image2latent(image))
            latents, trajs = batched.ddim_invert_batch(self.pipe, torch.stack(lats), [p[0] for p in pairs],
                                                       return_trajectory=True)
            if inversion == "null-text":
                # image by image (not nti_batch): the batch would iterate each
                # step to its slowest image (batched.nti_group_serial)
                uncond_seqs = batched.nti_group_serial(self.pipe, trajs, [p[0] for p in pairs],
                                                       cli.nti_config_for(method, self.pipe),
                                                       guidance_scale=cli.GUIDANCE_SCALE)
            elif inversion == "direct" and method != "p2z":
                source_replays = trajs  # each image replays its own trajectory
        else:
            latents = torch.stack([self.synthesis_latent(int(r.get("seed", 42))) for r in reqs])

        cfg = [_auto_p2p_config(*pair) for pair in pairs] if method == "p2p" else None
        imgs = batched.edit_batch(method, self.pipe, pairs, latents, cfg, uncond_seqs=uncond_seqs,
                                  source_replays=source_replays)
        latency = round(time.perf_counter() - t0, 3)
        responses = {}
        for name, d, pair_imgs in zip(names, out_dirs, imgs):
            savers[name](pair_imgs[0], os.path.join(d, "inversion.png"))
            savers[name](pair_imgs[1], os.path.join(d, "edit.png"))
            responses[name] = {"status": "ok", "outputs": d, "latency_s": latency, "batched_with": len(names)}
        self.stats["batched"] += len(names)
        return responses

    def _intake(self) -> list:
        """The parsed pending requests [(name, path, request)], in file-name
        order. A file that does not parse is left for ``PARSE_RETRIES``
        polls, then answered with an error and moved to ``rejected/``."""
        pending = []
        for fname in sorted(os.listdir(self.requests_dir)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(self.requests_dir, fname)
            name = os.path.splitext(fname)[0]
            try:
                with open(path) as f:
                    req = json.load(f)
            except Exception as e:  # noqa: BLE001 — maybe a torn write: retried, then answered
                n_fail = self._parse_failures.get(fname, 0) + 1
                self._parse_failures[fname] = n_fail
                if n_fail > self.PARSE_RETRIES:
                    self._respond(name, {"status": "error", "error": f"{type(e).__name__}: {e}"})
                    os.makedirs(self.rejected_dir, exist_ok=True)
                    # a name of its own: two bad requests under one file name
                    # over the service's life keep both their bytes
                    dst, n = os.path.join(self.rejected_dir, fname), 1
                    while os.path.exists(dst):
                        dst = os.path.join(self.rejected_dir, f"{name}.{n}.json")
                        n += 1
                    os.replace(path, dst)
                    del self._parse_failures[fname]
                continue
            self._parse_failures.pop(fname, None)
            pending.append((name, path, req))
        return pending

    def poll_once(self) -> int:
        """Process all pending requests (compatible ones grouped into one
        batched edit, up to ``max_batch``); returns how many were handled.
        Everything is answered and the request files removed when it
        returns."""
        pending = self._intake()
        # group compatible requests; None-keyed ones run one by one
        # (the dict keeps first-seen key order)
        groups: dict = {}
        for name, path, req in pending:
            groups.setdefault(self._batch_key(req), []).append((name, path, req))
        # every pending image's decode starts now, before the first group runs
        image_futures = {name: self._io_pool.submit(load_image, req["image_path"], self.res, self.res)
                         for name, _, req in pending if req.get("image_path")}

        def finalize(chunk, responses, saves):
            """Wait for the chunk's PNG encodes, then answer and remove the
            request files; a failed save turns that request's answer into an
            error."""
            for n, path, _ in chunk:
                for fut in saves.get(n, ()):
                    try:
                        fut.result()
                    except Exception as e:  # noqa: BLE001 — reported in the response
                        responses[n] = _error(e, "save failed: ")
                self._respond(n, responses[n])
                os.remove(path)

        handled, finalize_futures = 0, []
        for key, items in groups.items():
            while items:
                chunk = items[: self.max_batch] if key is not None else items[:1]
                items = items[len(chunk):]
                names = [n for n, _, _ in chunk]
                saves: dict = {}
                if key is not None and len(chunk) > 1:
                    try:
                        responses = self.handle_batch(names, [r for _, _, r in chunk], image_futures=image_futures,
                                                      saves=saves)
                    except Exception as e:  # noqa: BLE001 — a bad group never crashes the poll
                        responses = {n: _error(e) for n in names}
                else:
                    responses = {}
                    for n, _, req in chunk:
                        saves[n] = []
                        try:
                            responses[n] = self.handle(n, req, image_future=image_futures.get(n), saves=saves[n])
                        except Exception as e:  # noqa: BLE001 — a bad request never crashes the poll
                            responses[n] = _error(e)
                finalize_futures.append(self._finalize_pool.submit(finalize, chunk, responses, saves))
                handled += len(chunk)
        for fut in finalize_futures:
            fut.result()
        self.stats["handled"] += handled
        return handled

    def _respond(self, name: str, resp: dict) -> None:
        out_dir = os.path.join(self.results_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "response.json"), "w") as f:
            json.dump(resp, f, indent=2)

    def run_forever(self, poll_interval: float = 0.5) -> None:
        while True:
            if self.poll_once() == 0:
                time.sleep(poll_interval)


def main(argv=None) -> None:
    """Load ``--sd_version`` in bf16 on the card (``cli.load_pipe``) and
    serve the spool under ``--root`` until killed."""
    ap = argparse.ArgumentParser("editing service")
    ap.add_argument("--sd_version", default="1.5")
    ap.add_argument("--root", default="./service")
    args = ap.parse_args(argv)
    pipe = cli.load_pipe(args.sd_version, dtype=torch.bfloat16)
    EditService(pipe, args.root).run_forever()


if __name__ == "__main__":
    main()
