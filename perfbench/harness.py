"""The benchmark of ``image_editing_framework_torch``: one run of one cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration (its file
under ``perfbench/configs/``) and a traffic mix (``perfbench/traffic/<name>.json``);
its check limits are ``perfbench/checks/<cell>.json`` and each per-layer
metric is read by ``perfbench/metrics/<metric>.py``. A run:

1. makes the items, the vocabulary and the weights from ``--seed`` (weights
   on the device in bf16, handed to the port through ``models/loader.py
   load_params``), builds the port's pipeline, and warms every shape up with
   one group on a 2-step schedule;
2. measures: one ``eval/sweep.py run_sweep`` call (the body of
   ``cli.test_main``) over the item list, closed at the start of the first
   group after ``--seconds`` and once the sweep has waited for its saves and
   metrics; with ``--trace 1`` it records host spans over the whole window
   and profiles the device over one whole group;
3. frees the program and judges one group against the plain reference
   (``perfbench/check.py``), then prints the result line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import gen, yardstick
from perfbench.check import Judge, judge_group, verdict
from perfbench.hooks import Recorder
from perfbench.reference import editing, nets
from perfbench.reference.tokenizer import BPETokenizer

FORBIDDEN = ("jax", "jaxlib", "flax", "image_editing_framework_tpu")
WARMUP_STEPS = 2


class Refused(Exception):
    """A run that must exit without a result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_cell(root: str, name: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(root, "perfbench", "checks", name + ".json")
    limits = None
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)["limits"]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return bench, cell, cfg, traffic, limits, per_layer


def module_shapes(cfg: dict) -> Dict[str, dict]:
    shapes = {"unet": nets.unet_shapes(cfg["unet"]), "vae": nets.vae_shapes(cfg["vae"]),
              "text_encoder": nets.clip_shapes(cfg["text_encoder"])}
    if "text_encoder_2" in cfg:
        shapes["text_encoder_2"] = nets.clip_shapes(cfg["text_encoder_2"])
    return shapes


def make_weights(cfg: dict, seed: int, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    seeds = gen.module_seeds(seed)
    return {m: gen.weights(s, seeds[m], device, dtype) for m, s in module_shapes(cfg).items()}


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


# ------------------------------------------------------------ the program


def build_pipeline(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], tok_dir: str, device, dtype):
    """The port's pipeline from the configuration's sizes, each module built
    on ``meta`` and filled by the port's own diffusers-keyed loader."""
    from image_editing_framework_torch.core.scheduler import make_ddim_schedule
    from image_editing_framework_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from image_editing_framework_torch.models.loader import load_params
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer
    from image_editing_framework_torch.models.unet import UNet2DCondition, UNetConfig
    from image_editing_framework_torch.models.vae import AutoencoderKL, VAEConfig
    from image_editing_framework_torch.pipelines import SDPipeline

    u, v = cfg["unet"], cfg["vae"]
    heads = u["attention_head_dim"]
    n = len(u["block_out_channels"])
    depth = u.get("transformer_layers_per_block", 1)
    xl = u.get("addition_embed_type") == "text_time"
    ucfg = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]), down_block_types=tuple(u["down_block_types"]),
        up_block_types=tuple(u["up_block_types"]), layers_per_block=u["layers_per_block"],
        num_heads=tuple([heads] * n if isinstance(heads, int) else heads),
        transformer_layers=tuple([depth] * n if isinstance(depth, int) else depth),
        cross_attention_dim=u["cross_attention_dim"], use_linear_projection=u.get("use_linear_projection", False),
        addition_time_embed_dim=u.get("addition_time_embed_dim") if xl else None,
        projection_class_embeddings_input_dim=u.get("projection_class_embeddings_input_dim") if xl else None)
    vcfg = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"], latent_channels=v["latent_channels"],
                     block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
                     scaling_factor=v["scaling_factor"])

    def text_cfg(t):
        return CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                              num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                              intermediate_size=t["intermediate_size"], max_length=t["max_position_embeddings"],
                              hidden_act=t["hidden_act"],
                              projection_dim=t["projection_dim"] if t.get("with_projection") else None)

    def load(cls, c, w):
        with torch.device("meta"):
            module = cls(c)
        return load_params(module, w, dtype, device).eval().requires_grad_(False)

    s = cfg["scheduler"]
    tok = CLIPTokenizer.from_dir(tok_dir)
    return SDPipeline(
        model_type="xl" if xl else "sd",
        unet=load(UNet2DCondition, ucfg, weights["unet"]),
        vae=load(AutoencoderKL, vcfg, weights["vae"]),
        text_encoder=load(CLIPTextModel, text_cfg(cfg["text_encoder"]), weights["text_encoder"]),
        tokenizer=tok,
        scheduler=make_ddim_schedule(cfg["num_inference_steps"], s["num_train_timesteps"], s["beta_start"],
                                     s["beta_end"], s["beta_schedule"], s["steps_offset"], s["set_alpha_to_one"]),
        device=torch.device(device), dtype=dtype,
        text_encoder_2=load(CLIPTextModel, text_cfg(cfg["text_encoder_2"]), weights["text_encoder_2"]) if xl else None,
        tokenizer_2=tok if xl else None,
    )


def draw_steps(seed: int, steps: int, method: str):
    """The steps the check judges, the same in every group: three inversion
    steps, one from each third; edit (or pass-1) steps in P2P's windows of
    self- and cross-attention replacement, after both, and the last step;
    for pix2pix-zero three pass-2 steps, one from each third."""
    rng = np.random.default_rng([seed % 2**63, 7])
    thirds = np.array_split(np.arange(steps), 3)
    invert = sorted(int(rng.choice(t)) for t in thirds)
    self_end, cross_end = int(0.6 * steps), min(int(0.8 * (steps + 1)), steps - 1)
    windows = [np.arange(0, self_end), np.arange(self_end, cross_end), np.arange(cross_end, steps - 1)]
    edit = sorted({int(rng.choice(w)) for w in windows if len(w)} | {steps - 1})
    pass2 = sorted(int(rng.choice(t)) for t in thirds) if method == "p2z" else []
    return invert, edit, pass2


# ------------------------------------------------------------------ FLOPs


def latent_side(cfg: dict) -> int:
    return cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


def group_flops(cfg: dict, method: str, g: int) -> float:
    """Model FLOPs of one group (its text encodes, VAE encodes, inversion,
    edit and decodes) counted over the reference on ``meta`` tensors."""
    meta = torch.device("meta")
    params = {m: {k: torch.empty(s, device=meta) for k, s in sh.items()} for m, sh in module_shapes(cfg).items()}
    model = editing.Model(cfg, params, None, meta)
    steps, side = cfg["num_inference_steps"], latent_side(cfg)
    cross = cfg["unet"]["cross_attention_dim"]
    pooled = torch.empty(1, cfg["text_encoder_2"]["projection_dim"], device=meta) if model.xl else None
    x1 = torch.empty(1, 4, side, side, device=meta)
    ctx1 = torch.empty(1, 77, cross, device=meta)
    ids = torch.zeros(1, 77, dtype=torch.int64, device=meta)
    count = yardstick.count_flops
    text = count(lambda: nets.clip_text(params["text_encoder"], cfg["text_encoder"], ids))
    if model.xl:
        text += count(lambda: nets.clip_text(params["text_encoder_2"], cfg["text_encoder_2"], ids))
    unet1 = count(lambda: model.eps(x1, 1, ctx1, pooled))
    res = cfg["resolution"]
    enc = count(lambda: nets.vae_encode(params["vae"], cfg["vae"], torch.empty(1, 3, res, res, device=meta)))
    dec = count(lambda: model.decode(x1))
    total = text * 2 * g + enc * g + unet1 * steps * g + dec * 2 * g
    if method == "p2p":
        return total + text * 4 * g + unet1 * steps * 4 * g
    pooled2 = None if pooled is None else pooled.expand(2, -1)

    def grad():
        x = torch.empty(2, 4, side, side, device=meta, requires_grad=True)
        with torch.enable_grad():
            rec = editing.RecordCross()
            model.eps(x, 1, ctx1.expand(2, -1, -1), pooled2, rec)
            torch.autograd.grad(sum(m.square().sum() for m in rec.maps), x)

    return total + text * 4 * g + unet1 * steps * 2 * g * 2 + count(grad) * steps * g


# -------------------------------------------------------------------- run


class WindowClosed(BaseException):
    """Raised at the start of the first group after the window's time is
    up; a ``BaseException``, so that no handler of the program's takes it."""


class Window:
    """The measured window over one ``run_sweep`` call, kept by a wrapper on
    ``eval/sweep.py``'s ``_edit_group``. At each group's start it closes the
    group before, ends the window once ``seconds`` have passed (by raising
    ``WindowClosed``; the sweep's ``finally`` then waits for its saves and
    metrics), and with ``profile`` captures the device over group
    ``TRACE_GROUP``, from its start to the next group's."""

    TRACE_GROUP = 1  # the second: the first has grown the allocator

    def __init__(self, rec: Recorder, seconds: float, trace: bool, profile: bool, method: str):
        self.rec, self.seconds, self.trace, self.profile, self.method = rec, seconds, trace, profile, method
        self.t0_ns = 0
        self.overhead_ns = 0  # starting and stopping the profiler: not the program's time
        self.started = self.groups = 0
        self.group_s: List[float] = []
        self.capture = None
        self.attn_calls: List[tuple] = []
        self._tg = 0
        self._profiling = False

    def close_group(self, now_ns: int) -> None:
        if self.groups < self.started:
            self.rec.finish_group(self.method)
            self.group_s.append((now_ns - self._tg) / 1e9)
            self.groups = self.started

    def stop_profile(self) -> None:
        if self._profiling:
            from perfbench.trace import stop

            stop(self.capture)
            self.overhead_ns += time.perf_counter_ns() - self.capture.t1_ns
            self._profiling = self.rec.attn_on = False
            self.attn_calls, self.rec.attn_calls = self.rec.attn_calls, []

    def wrap(self, orig):
        def edit_group(*a, **kw):
            now = time.perf_counter_ns()
            self.close_group(now)
            if self.started == self.TRACE_GROUP + 1:
                self.stop_profile()
            if (self.started and (time.perf_counter_ns() - self.t0_ns - self.overhead_ns) / 1e9 >= self.seconds
                    and (not self.trace or self.started > self.TRACE_GROUP)):
                raise WindowClosed
            if self.profile and self.started == self.TRACE_GROUP:
                from perfbench.trace import start

                t = time.perf_counter_ns()
                self.capture = start()
                self.overhead_ns += self.capture.t0_ns - t
                self._profiling = self.rec.attn_on = True
            self.rec.group = self.started
            self._tg = time.perf_counter_ns()
            self.started += 1
            return orig(*a, **kw)
        return edit_group


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        faults=None, t_start: Optional[float] = None, control: bool = False) -> dict:
    """One run; returns the result line's dict. ``t_start`` is the process's
    start on ``time.perf_counter``; ``faults`` (tests) is called with the
    recorder once the hooks are in, to break the timed path; ``control``
    also judges the float8 control at the same states (``result["control"]``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, traffic, limits, per_layer = load_cell(root, workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} CUDA device(s); "
                          f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from image_editing_framework_torch.eval import sweep as program  # imported after the chip check

    dtype = dtype_of(cfg)
    g, method = traffic["batch_size"], traffic["method"]
    steps = cfg["num_inference_steps"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    scratch = tempfile.mkdtemp(prefix="perfbench-")
    rec = None
    try:
        item_list = gen.items(traffic, seed)
        data = gen.write_pie(os.path.join(scratch, "pie"), item_list, traffic["image_side"])
        warm = gen.write_pie(os.path.join(scratch, "warm"), gen.items(dict(traffic, items=g), seed + 1),
                             traffic["image_side"])
        tok_dir = gen.write_vocab(os.path.join(scratch, "tokenizer"), traffic["words"])
        ref_tok = BPETokenizer.from_dir(tok_dir)
        for w in traffic["words"]:
            editing._word_token(ref_tok, w)
        order = gen.sweep_order(data, traffic["categories"])
        by_key = {f"{traffic['categories'][k % len(traffic['categories'])]}_synthetic/{k:06d}": it
                  for k, it in enumerate(item_list)}

        weights = make_weights(cfg, seed, device, dtype)
        pipe = build_pipeline(cfg, weights, tok_dir, device, dtype)
        del weights
        invert_steps, edit_steps, pass2_steps = draw_steps(seed, steps, method)
        rec = Recorder(steps, invert_steps, edit_steps, pass2_steps)
        rec.sync = sync
        rec.install()
        if faults is not None:
            faults(rec)

        def sweep(ds, exp, max_items=None):
            return program.run_sweep(pipe, method, ds, exp, inversion_type=traffic["inversion"],
                                     categories=traffic["categories"], resume=False, max_items=max_items,
                                     resolution=cfg["resolution"], batch_size=g,
                                     record_metrics=traffic["record_metrics"], seed=seed)

        # warm-up: every shape of the cell, on a 2-step schedule
        from image_editing_framework_torch.core.scheduler import make_ddim_schedule

        full = pipe.scheduler
        pipe.scheduler = make_ddim_schedule(WARMUP_STEPS, full.num_train_timesteps)
        rec.steps, saved_steps = WARMUP_STEPS, (rec.invert_steps, rec.edit_steps, rec.pass2_steps)
        rec.invert_steps = rec.edit_steps = rec.pass2_steps = []
        sweep(warm, os.path.join(scratch, "warm_out"), g)
        pipe.scheduler = full
        rec.steps = steps
        rec.invert_steps, rec.edit_steps, rec.pass2_steps = saved_steps
        rec.captures.clear()
        sync()
        gc.collect()

        # the window: one sweep over the item list, closed at a group's start
        exp = os.path.join(scratch, "out")
        window = Window(rec, seconds, trace, trace and device == "cuda", method)
        rec._patch(program, "_edit_group", window.wrap)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rec.spans_on = trace
        setup_s = time.perf_counter() - t_start
        window.t0_ns = time.perf_counter_ns()
        try:
            sweep(data, exp)
        except WindowClosed:
            pass
        else:  # the sweep ran out of items: its last group ends the window if the time is up
            if not window.started:
                raise Refused("the hook on eval.sweep._edit_group saw no call: the window has no groups")
            sync()
            window.close_group(time.perf_counter_ns())
        sync()
        window_s = (time.perf_counter_ns() - window.t0_ns - window.overhead_ns) / 1e9
        window.stop_profile()  # where the sweep ran out inside the traced group
        if window_s < seconds:
            raise Refused(f"the item list ran out after {window.groups * g} images: raise 'items' in the "
                          "traffic file")
        k, done, capture = window.groups, window.groups * g, window.capture
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        keys = order[: done]
        failed = sum(not os.path.exists(os.path.join(exp, key, "edit.png")) for key in keys)

        result = {"correct": False, "attempted": done, "failed": int(failed), "measured_s": window_s,
                  "groups": k, "group_s": window.group_s}
        if capture is not None:
            from perfbench.trace import read

            t_read = time.perf_counter()
            read(capture)
            result["trace_read_s"] = time.perf_counter() - t_read
        if trace:
            ctx = SimpleNamespace(images=done, window_s=window_s, spans=list(rec.spans), capture=capture,
                                  attn_calls=window.attn_calls, group=g, method=method,
                                  flops_per_group=group_flops(cfg, method, g))
            metrics = {}
            for m in per_layer:
                value = read_metric(root, m["name"], ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
        else:
            result["metrics"] = {
                "images_per_s": {"value": done / window_s, "unit": "images/s"},
                "device_peak_gib": {"value": peak / 2**30, "unit": "GiB"},
                "setup_s": {"value": setup_s, "unit": "s"},
            }
        result["device"] = device_line(device, peak)
        if trace and capture is not None:
            result["device"].update(busy_s=capture.busy_s, window_s=capture.wall_s)
            result["breakdown"] = {"device_ops": capture.top_ops(), "idle_gaps": capture.idle_by_span(rec.spans)}

        # free the program, then judge one group against the reference
        judged = int(np.random.default_rng([seed % 2**63, 11]).integers(0, done // g))
        missing = rec.missing(judged, method)
        rec.restore()
        captures, rec = rec.captures, None
        del pipe
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        group_keys = keys[judged * g:(judged + 1) * g]
        args = (cfg, traffic, seed, device, tok_dir, captures.get(judged), [by_key[key] for key in group_keys],
                [paths_of(data, exp, key) for key in group_keys])
        t_check = time.perf_counter()
        detail: Optional[list] = [] if control else None
        if missing:  # the timed path no longer calls a name the check reads its states at
            numbers = {"missing_state": float("inf")}
            for m in missing:
                print(f"perfbench: no capture of {m} in the judged group", file=sys.stderr)
        else:
            numbers = judge(*args, detail=detail)
        result["check_s"] = time.perf_counter() - t_check
        if control:
            result["control"] = judge(*args, precision="fp8", detail=detail)
            result["check_detail"] = detail
        ok, rows = verdict(numbers, limits)
        result["correct"] = bool(ok and failed == 0)
        result["readings"] = numbers
        result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
        return result
    finally:
        if rec is not None:
            rec.restore()
        shutil.rmtree(scratch, ignore_errors=True)


def paths_of(data: str, exp: str, key: str) -> dict:
    return {"source": os.path.join(data, "annotation_images", key + ".jpg"),
            "inversion": os.path.join(exp, key, "inversion.png"), "edit": os.path.join(exp, key, "edit.png")}


def reference_model(cfg: dict, seed: int, device, tok_dir: str) -> editing.Model:
    """The reference's networks: the run's weights made again from the seed
    in the served dtype, then held in float32."""
    weights = make_weights(cfg, seed, device, dtype_of(cfg))
    params = {m: {k: v.float() for k, v in w.items()} for m, w in weights.items()}
    del weights
    return editing.Model(cfg, params, BPETokenizer.from_dir(tok_dir), torch.device(device))


def judge(cfg, traffic, seed, device, tok_dir, cap, items, paths, precision: str = "f32",
          detail: Optional[list] = None) -> Dict[str, float]:
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = reference_model(cfg, seed, device, tok_dir)
        sch = editing.schedule(cfg["num_inference_steps"], cfg["scheduler"])
        j = Judge(model, sch, traffic["method"], cfg["guidance_scale"], dtype_of(cfg), precision)
        numbers = judge_group(j, cap, items, paths)
        if detail is not None:
            detail.append({"invert": j.detail, "all": j.numbers})
        return numbers
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def read_metric(root: str, name: str, ctx) -> Optional[float]:
    """The per-layer metric ``name`` by its reader ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def device_line(device: str, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": int(peak)}
