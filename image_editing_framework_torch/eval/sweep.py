"""The PIE-Bench sweep, one image at a time or in batched groups.

Counterpart of ``image_editing_framework_tpu/eval/sweep.py``.
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
card: the worker threads decode and encode PNG/JPEG and compute the
structure metrics on host arrays, while the CLIP score and LPIPS towers
run on the calling thread, on the pipeline's device, after each image's or
group's edit (one tower call for a group).
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

from image_editing_framework_torch.cli import GUIDANCE_SCALE, INVERSION_TYPES, nti_config_for
from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE, PIEPrecomputedInversion, save_inversion
from image_editing_framework_torch.eval import batched
from image_editing_framework_torch.eval import metrics as qmetrics
from image_editing_framework_torch.eval.lpips import LPIPS
from image_editing_framework_torch.utils import profiling
from image_editing_framework_torch.utils.images import load_image, save_img


def _auto_p2p_config(source_prompt: str, target_prompt: str) -> P2PConfig:
    """replace if equal word counts else refine (p2p/test.py:120-123)."""
    if len(source_prompt.split(" ")) == len(target_prompt.split(" ")):
        return P2PConfig(edit_type="replace")
    return P2PConfig(edit_type="refine")


def _edit_group(pipe, method, group, images, inversion_type, method_kwargs, sampler, cached, save_inversions):
    """One group of the batched sweep (JAX ``sweep.py:257-341``): its
    inversions from the cache (``cached``) or by ``ddim_invert_batch``
    (null-text then image by image, ``nti_group_serial``; direct with each
    image's trajectory replayed), each image's inversion saved if asked,
    then one batched edit. Returns each image's (inversion, edit) uint8.
    A torch profiler running at the group's start turns the tracer on
    (``utils/profiling.py follow_profiler``)."""
    profiling.follow_profiler()
    with profiling.phase("group", allocs=True):
        src_prompts = [it.source_prompt for it in group]
        source_replays = uncond_seqs = None
        if cached is not None:
            # the cache holds no trajectory: direct inversion edits as ddim here,
            # as on the serial cache path
            loaded = [cached(it) for it in group]
            inverted = torch.stack([lat for lat, _ in loaded])
            if inversion_type == "null-text":
                if any(u is None for _, u in loaded):
                    raise ValueError("null-text batched sweep from inversion_path needs a cached uncond_seq for every "
                                     "image")
                uncond_seqs = torch.stack([u for _, u in loaded])
        else:
            with profiling.phase("encode"):
                lats = torch.stack([pipe.image2latent(image) for image in images])  # (G, 1, h, w, 4)
            inverted, trajs = batched.ddim_invert_batch(pipe, lats, src_prompts, return_trajectory=True)
            if inversion_type == "null-text":
                uncond_seqs = batched.nti_group_serial(pipe, trajs, src_prompts, nti_config_for(method, pipe),
                                                       guidance_scale=GUIDANCE_SCALE)
            elif inversion_type == "direct":
                source_replays = trajs
        if save_inversions:
            for gi, item in enumerate(group):
                save_inversion(save_inversions, item.key, inverted[gi],
                               None if uncond_seqs is None else uncond_seqs[gi])
        cfg = (method_kwargs or {}).get("config")
        if method == "p2p":
            cfg = [cfg or _auto_p2p_config(it.source_prompt, it.target_prompt) for it in group]
        imgs = batched.edit_batch(method, pipe, [[it.source_prompt, it.target_prompt] for it in group], inverted, cfg,
                                  sampler.guidance_scale, uncond_seqs=uncond_seqs, source_replays=source_replays)
        return [(pair[0], pair[1]) for pair in imgs]


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

    ``batch_size`` > 1 edits the items in groups of that many, each group in
    one batch (``eval/batched.py``; ddim, null-text or direct inversion,
    with the cache as with one image): the group's inversion and edit are
    batched, its null-text inversion runs image by image
    (``nti_group_serial``), each image's time is the group's over its size,
    and the steady-state stats leave out the first group. The next group's
    images are decoded while the card computes.

    With ``record_metrics``, each image's row holds MSE / PSNR / SSIM of its
    reconstruction against its source and, when their weights are given,
    ``clip_score_edit`` (``eval/metrics.py CLIPScore`` of the edit against
    the target prompt; ``clip_checkpoint`` is a CLIP checkpoint directory)
    and ``lpips_src_edit`` (``eval/lpips.py LPIPS`` of source against edit;
    ``lpips_weights`` a state dict of its net or the path of one
    ``.safetensors`` file). A tower that fails counts as a failed metric, as
    on the JAX package's metric threads."""
    if batch_size > 1 and inversion_type not in INVERSION_TYPES:
        raise ValueError("batched sweep supports ddim/null-text/direct inversion")
    from image_editing_framework_torch.cli import invert, run_method

    res = resolution or (1024 if pipe.model_type == "xl" else 512)
    prev_tile = pipe.decode_tile_latent
    if pipe.model_type == "xl" and res >= 1024 and pipe.decode_tile_latent is None:
        # Memory-safety default of the JAX package (the full-frame 1024²
        # decode beside the resident XL models), kept so both sweeps decode
        # alike. Restored after the sweep: the pipe outlives this call.
        pipe.decode_tile_latent = 64
    sampler = SamplerConfig(height=res, width=res, seed=seed)
    times, group_times = [], []  # each image's time; each group's over its size, once a group
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

    clip_scorer = lpips_fn = None
    if record_metrics:
        if clip_checkpoint:
            clip_scorer = qmetrics.CLIPScore(clip_checkpoint, device=pipe.device)
        if lpips_weights is not None:
            lpips_fn = LPIPS(lpips_weights, device=pipe.device)
    tower_errors = []

    def tower_rows(group, images, imgs):
        """Each image's CLIP score and LPIPS, one call of each tower for the
        group, on the calling thread; a failure is recorded once for each
        image of the group (as a failed metric task per image is), not
        raised, and the images' rows go on without the towers."""
        rows = [{} for _ in group]
        if clip_scorer is None and lpips_fn is None:
            return rows
        try:
            edits = np.stack([np.asarray(edit) for _, edit in imgs])
            if clip_scorer is not None:
                for row, v in zip(rows, clip_scorer.scores(edits, [it.target_prompt for it in group]).tolist()):
                    row["clip_score_edit"] = v
            if lpips_fn is not None:
                for row, v in zip(rows, lpips_fn.distances(np.stack(images), edits).tolist()):
                    row["lpips_src_edit"] = v
        except Exception as e:  # noqa: BLE001 — a metric failure; the stats record it
            tower_errors.extend([e] * len(group))
            return [{} for _ in group]
        return rows

    pool = ThreadPoolExecutor(max_workers=8)
    # the metrics on their own two workers, so that queued metric tasks never
    # hold up the next image's decode on the IO pool
    metric_pool = ThreadPoolExecutor(max_workers=2)
    save_futures, metric_futures, metric_rows = [], [], []

    def save_async(img, path):
        save_futures.append(pool.submit(save_img, img, path))

    def _metrics_and_log(src_img, inv_img, rec, towers):
        if record_metrics:
            row = {}
            # a cache may hold latents at another resolution than this sweep
            # decodes at; the reconstruction metrics compare like with like
            if np.shape(src_img)[-3:] == np.shape(inv_img)[-3:]:
                row.update({"recon_mse": qmetrics.mse(src_img, inv_img),
                            "recon_psnr": qmetrics.psnr(src_img, inv_img),
                            "recon_ssim": qmetrics.ssim(src_img, inv_img)})
            row.update(towers)
            metric_rows.append(row)
            rec.update(_json_safe_metrics(row))
        # one whole line per open-append-close: lines stay whole under the
        # pool's interleaving (their order may differ from the images')
        with open(event_log, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def finish(item, src_img, inv_img, edit_img, elapsed, towers):
        out_dir = os.path.join(exp_path, item.key)
        save_async(inv_img, os.path.join(out_dir, "inversion.png"))
        save_async(edit_img, os.path.join(out_dir, "edit.png"))
        times.append(elapsed)
        rec = {"key": item.key, "elapsed_s": round(elapsed, 3), "source_prompt": item.source_prompt,
               "target_prompt": item.target_prompt}
        metric_futures.append(metric_pool.submit(_metrics_and_log, src_img, inv_img, rec, towers))

    try:
        cache = None
        if inversion_path is not None:
            # completeness is checked against this sweep's work list
            cache = PIEPrecomputedInversion(dataset_path, inversion_path, required_items=pending)
            by_key = {it.key: it for it in cache.items}

        def cached(item):
            """(latent, uncond_seq or None) of ``item`` from the cache, on the card."""
            lat_np, uncond_np = cache.load_inversion(by_key[item.key])
            return (torch.from_numpy(lat_np).to(pipe.device, pipe.dtype),
                    None if uncond_np is None else torch.from_numpy(uncond_np).to(pipe.device))

        groups = [pending[g0:g0 + batch_size] for g0 in range(0, len(pending), batch_size)]

        def load_group(group):
            return [load_image(it.image_path, res, res) for it in group]

        # the next group's decodes run while the card computes this one's
        load_future = pool.submit(load_group, groups[0]) if groups else None
        for gi, group in enumerate(groups):
            t0 = time.perf_counter()
            with profiling.phase("load_wait"):
                images = load_future.result()
            load_future = pool.submit(load_group, groups[gi + 1]) if gi + 1 < len(groups) else None
            for item, image in zip(group, images):
                os.makedirs(os.path.join(exp_path, item.key), exist_ok=True)
                save_async(image, os.path.join(exp_path, item.key, "source.png"))
            if batch_size > 1:
                imgs = _edit_group(pipe, method, group, images, inversion_type, method_kwargs, sampler,
                                   cached if cache is not None else None, save_inversions)
            else:
                item, image = group[0], images[0]
                traj = None
                if cache is not None:
                    latent, uncond_seq = cached(item)
                else:
                    latent, traj, uncond_seq = invert(pipe, image, item.source_prompt, inversion_type, method)
                if save_inversions:
                    save_inversion(save_inversions, item.key, latent, uncond_seq)
                kw = dict(method_kwargs or {})
                if method == "p2p" and "config" not in kw:
                    kw["config"] = _auto_p2p_config(item.source_prompt, item.target_prompt)
                replay = traj if inversion_type == "direct" else None
                imgs = [run_method(method, pipe, [item.source_prompt, item.target_prompt], latent, sampler,
                                   uncond_seq, kw, source_replay=replay)]
            elapsed = (time.perf_counter() - t0) / len(group)
            group_times.append(elapsed)
            with profiling.phase("towers"):
                rows = tower_rows(group, images, imgs)
            for item, image, (inv_img, edit_img), row in zip(group, images, imgs, rows):
                finish(item, image, inv_img, edit_img, elapsed, row)
            done += len(group)
    finally:
        with profiling.phase("drain"):
            pool.shutdown(wait=True)  # drain the workers even when an image failed
            metric_pool.shutdown(wait=True)
        profiling.stop_following()
        pipe.decode_tile_latent = prev_tile
    # A metric failure keeps the stats of a sweep whose edits all succeeded:
    # errors are recorded in the stats, the stats file is written, and then
    # a save error raises (missing outputs are a failed sweep) while a
    # metric or event-log error only warns.
    save_errors, metric_errors = [], list(tower_errors)
    for futures, errors in ((save_futures, save_errors), (metric_futures, metric_errors)):
        for fut in futures:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — recorded, raised or warned below
                errors.append(e)
    wall = time.perf_counter() - t_start
    tail = times[max(1, batch_size):]  # the first image, or the first group, pays the warm-up
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
    group_tail = group_times[1:]  # the percentiles over groups, not over a group's copies
    if group_tail:
        stats["p50_s_per_image"] = round(float(np.percentile(group_tail, 50)), 3)
        stats["p95_s_per_image"] = round(float(np.percentile(group_tail, 95)), 3)
        stats["max_s_per_image"] = round(float(np.max(group_tail)), 3)
    with open(os.path.join(exp_path, f"sweep_stats_{method}_{shard_index}.json"), "w") as f:
        json.dump(stats, f, indent=2)
    if metric_errors:
        warnings.warn(f"{len(metric_errors)} metric/event-log task(s) failed (first: {metric_errors[0]!r}); edits "
                      "and timing stats are intact — see sweep_stats metric_errors fields", stacklevel=2)
    if save_errors:
        raise RuntimeError(f"{len(save_errors)} output save(s) failed — sweep artifacts are incomplete (stats file "
                           f"was still written): {save_errors[0]!r}") from save_errors[0]
    return stats
