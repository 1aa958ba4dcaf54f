"""The PIE-Bench sweep, one image at a time.

Counterpart of ``image_editing_framework_tpu/eval/sweep.py`` at batch 1.
Reference shape (p2p/test.py:114-181): loop categories [0-4, 6-9] (5 is
skipped), per image invert -> edit -> save
``test_exp/<image>/{source,inversion,edit}.png``; P2P picks replace vs
refine by word-count equality (p2p/test.py:120-123).

As in the JAX package:
* images whose output directory already holds edit.png are skipped
  (resume);
* ``shard_index`` / ``shard_count`` stride the sweep's whole item list, so
  shards stay balanced when a category holds fewer items than shards;
* ``save_inversions`` writes each image's inversion to the cache
  ``inversion_path`` reads (``data/pie.py``);
* per-image events and the sweep's stats go to
  ``events_{method}_{shard}.jsonl`` and ``sweep_stats_{method}_{shard}.json``
  under ``exp_path``, with the JAX package's keys.

In the port the kernels or their plain versions are picked by the tensors'
device (there is no ``use_flash``), and ``device_peak_bytes`` is the card's
``torch.cuda.max_memory_allocated``. Only the calling thread touches the
card: the worker threads decode and encode PNG/JPEG and compute the metrics
on host arrays.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE, PIEPrecomputedInversion, save_inversion
from image_editing_framework_torch.eval import metrics as qmetrics
from image_editing_framework_torch.utils.images import load_image, save_img


def _auto_p2p_config(source_prompt: str, target_prompt: str) -> P2PConfig:
    """replace if equal word counts else refine (p2p/test.py:120-123)."""
    if len(source_prompt.split(" ")) == len(target_prompt.split(" ")):
        return P2PConfig(edit_type="replace")
    return P2PConfig(edit_type="refine")


def _json_safe_metrics(row: dict) -> dict:
    """Round metric values for the event log, mapping non-finite values to
    null: a perfect reconstruction yields psnr=inf, which json.dumps would
    emit as the bare ``Infinity`` token that strict RFC-8259 parsers (jq,
    JSON.parse) reject."""
    return {k: round(v, 5) if np.isfinite(v) else None for k, v in row.items()}


def run_sweep(
    pipe,
    method: str,
    dataset_path: str,
    exp_path: str,
    inversion_type: str = "ddim",
    seed: int = 42,
    categories=DEFAULT_CATEGORIES,
    method_kwargs: Optional[dict] = None,
    resume: bool = True,
    shard_index: int = 0,
    shard_count: int = 1,
    max_items: Optional[int] = None,
    resolution: Optional[int] = None,
    batch_size: int = 1,
    save_inversions: Optional[str] = None,
    inversion_path: Optional[str] = None,
    record_metrics: bool = True,
    clip_checkpoint: Optional[str] = None,
    lpips_weights=None,
) -> dict:
    """Invert and edit every pending PIE item of ``categories`` (this
    shard's, at most ``max_items`` counted with the skipped ones) with
    ``method`` on ``pipe``; returns the stats it writes.

    ``save_inversions`` writes the per-image inversion artifacts the
    reference's PIE_NTI_Inversion dataset consumes; ``inversion_path``
    consumes them and skips the inversion (p2p/dataset/pie.py:25-51). The
    cache holds no trajectory, so ``direct`` inversion from it runs plain
    ddim editing, with a warning and ``inversion_type_effective`` in the
    stats. PNG decode and encode run on a pool of 8 threads (the reference's
    DataLoader num_workers=8, p2p/test.py:116), the metrics on their own 2.

    Not ported yet: ``batch_size`` > 1 (ROADMAP.md A4) and the CLIP score
    and LPIPS metrics (``clip_checkpoint``, ``lpips_weights``: A3); each
    raises NotImplementedError."""
    if batch_size > 1:
        raise NotImplementedError("batch_size > 1 (the batched sweep) is not ported yet: ROADMAP.md A4")
    if clip_checkpoint or lpips_weights is not None:
        raise NotImplementedError("the sweep's CLIP score and LPIPS metrics (clip_checkpoint, lpips_weights) are "
                                  "not ported yet: ROADMAP.md A3")
    from image_editing_framework_torch.cli import invert, run_method

    res = resolution or (1024 if pipe.model_type == "xl" else 512)
    prev_tile = pipe.decode_tile_latent
    if pipe.model_type == "xl" and res >= 1024 and pipe.decode_tile_latent is None:
        # Memory-safety default of the JAX package (the full-frame 1024²
        # decode beside the resident XL models), kept so both sweeps decode
        # alike. Restored after the sweep: the pipe outlives this call.
        pipe.decode_tile_latent = 64
    sampler = SamplerConfig(height=res, width=res, seed=seed)
    times = []
    done = skipped = 0
    t_start = time.perf_counter()
    pending = []
    all_items = []
    for category in categories:
        all_items.extend(PIE(dataset_path, category).items)
    for item in all_items[shard_index::shard_count]:
        if max_items is not None and len(pending) + skipped >= max_items:
            break
        if resume and os.path.exists(os.path.join(exp_path, item.key, "edit.png")):
            skipped += 1
            continue
        pending.append(item)

    os.makedirs(exp_path, exist_ok=True)
    event_log = os.path.join(exp_path, f"events_{method}_{shard_index}.jsonl")

    inversion_type_effective = inversion_type
    if inversion_path is not None and inversion_type == "direct":
        inversion_type_effective = "ddim (cache has no trajectory)"
        warnings.warn(
            "inversion_type='direct' with inversion_path: cached artifacts hold no latent trajectory, so "
            "source-branch replay is NOT applied — the sweep runs plain ddim editing "
            "(stats['inversion_type_effective'] records this)", stacklevel=2)

    pool = ThreadPoolExecutor(max_workers=8)
    # the metrics on their own two workers, so that queued metric tasks never
    # hold up the next image's decode on the IO pool
    metric_pool = ThreadPoolExecutor(max_workers=2)
    save_futures, metric_futures, metric_rows = [], [], []

    def save_async(img, path):
        save_futures.append(pool.submit(save_img, img, path))

    def _metrics_and_log(src_img, inv_img, rec):
        if record_metrics:
            row = {}
            # a cache may hold latents at another resolution than this sweep
            # decodes at; the reconstruction metrics compare like with like
            if np.shape(src_img)[-3:] == np.shape(inv_img)[-3:]:
                row.update({"recon_mse": qmetrics.mse(src_img, inv_img),
                            "recon_psnr": qmetrics.psnr(src_img, inv_img),
                            "recon_ssim": qmetrics.ssim(src_img, inv_img)})
            metric_rows.append(row)
            rec.update(_json_safe_metrics(row))
        # one whole line per open-append-close: lines stay whole under the
        # pool's interleaving (their order may differ from the images')
        with open(event_log, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def finish(item, src_img, inv_img, edit_img, elapsed):
        out_dir = os.path.join(exp_path, item.key)
        save_async(inv_img, os.path.join(out_dir, "inversion.png"))
        save_async(edit_img, os.path.join(out_dir, "edit.png"))
        times.append(elapsed)
        rec = {"key": item.key, "elapsed_s": round(elapsed, 3), "source_prompt": item.source_prompt,
               "target_prompt": item.target_prompt}
        metric_futures.append(metric_pool.submit(_metrics_and_log, src_img, inv_img, rec))

    try:
        cache = None
        if inversion_path is not None:
            # completeness is checked against this sweep's work list
            cache = PIEPrecomputedInversion(dataset_path, inversion_path, required_items=pending)
            by_key = {it.key: it for it in cache.items}
        load_future = pool.submit(load_image, pending[0].image_path, res, res) if pending else None
        for idx, item in enumerate(pending):
            out_dir = os.path.join(exp_path, item.key)
            os.makedirs(out_dir, exist_ok=True)
            t0 = time.perf_counter()
            image = load_future.result()
            load_future = (pool.submit(load_image, pending[idx + 1].image_path, res, res)
                           if idx + 1 < len(pending) else None)
            save_async(image, os.path.join(out_dir, "source.png"))
            traj = None
            if cache is not None:
                lat_np, uncond_np = cache.load_inversion(by_key[item.key])
                latent = torch.from_numpy(lat_np).to(pipe.device, pipe.dtype)
                uncond_seq = None if uncond_np is None else torch.from_numpy(uncond_np).to(pipe.device)
            else:
                latent, traj, uncond_seq = invert(pipe, image, item.source_prompt, inversion_type, method)
            if save_inversions:
                save_inversion(save_inversions, item.key, latent, uncond_seq)
            kw = dict(method_kwargs or {})
            if method == "p2p" and "config" not in kw:
                kw["config"] = _auto_p2p_config(item.source_prompt, item.target_prompt)
            replay = traj if inversion_type == "direct" else None
            inv_img, edit_img = run_method(method, pipe, [item.source_prompt, item.target_prompt], latent, sampler,
                                           uncond_seq, kw, source_replay=replay)
            finish(item, image, inv_img, edit_img, time.perf_counter() - t0)
            done += 1
    finally:
        pool.shutdown(wait=True)  # drain the workers even when an image failed
        metric_pool.shutdown(wait=True)
        pipe.decode_tile_latent = prev_tile
    # A metric failure keeps the stats of a sweep whose edits all succeeded:
    # errors are recorded in the stats, the stats file is written, and then
    # a save error raises (missing outputs are a failed sweep) while a
    # metric or event-log error only warns.
    save_errors, metric_errors = [], []
    for futures, errors in ((save_futures, save_errors), (metric_futures, metric_errors)):
        for fut in futures:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — recorded, raised or warned below
                errors.append(e)
    wall = time.perf_counter() - t_start
    tail = times[1:]  # the first image pays the warm-up
    stats = {
        "method": method,
        "inversion_type": inversion_type,
        "inversion_type_effective": inversion_type_effective,
        "images_done": done,
        "images_skipped": skipped,
        "wall_s": round(wall, 2),
        "mean_s_per_image": round(float(np.mean(times)), 3) if times else None,
        "steady_s_per_image": round(float(np.mean(tail)), 3) if tail else None,
    }
    for k in sorted({k for r in metric_rows for k in r}):
        vals = [r[k] for r in metric_rows if k in r and np.isfinite(r[k])]
        if vals:
            stats[f"{k}_mean"] = round(float(np.mean(vals)), 5)
    if metric_errors:
        stats["metric_errors"] = len(metric_errors)
        stats["metric_error_first"] = repr(metric_errors[0])
    if save_errors:
        stats["save_errors"] = len(save_errors)
        stats["save_error_first"] = repr(save_errors[0])
    if pipe.device.type == "cuda":
        stats["device_peak_bytes"] = int(torch.cuda.max_memory_allocated(pipe.device))
    import resource

    stats["host_peak_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    if tail:
        stats["p50_s_per_image"] = round(float(np.percentile(tail, 50)), 3)
        stats["p95_s_per_image"] = round(float(np.percentile(tail, 95)), 3)
        stats["max_s_per_image"] = round(float(np.max(tail)), 3)
    with open(os.path.join(exp_path, f"sweep_stats_{method}_{shard_index}.json"), "w") as f:
        json.dump(stats, f, indent=2)
    if metric_errors:
        warnings.warn(f"{len(metric_errors)} metric/event-log task(s) failed (first: {metric_errors[0]!r}); edits "
                      "and timing stats are intact — see sweep_stats metric_errors fields", stacklevel=2)
    if save_errors:
        raise RuntimeError(f"{len(save_errors)} output save(s) failed — sweep artifacts are incomplete (stats file "
                           f"was still written): {save_errors[0]!r}") from save_errors[0]
    return stats
