"""What the harness wraps around the program, from outside it.

``Recorder.install`` replaces module-level names that the sweep calls
(``eval/batched.py``'s ``ddim_invert_batch``, ``edit_batch``,
``_denoise_scan``, ``_guided_scan_group``, ``_decode_pairs``; the DDIM
step functions as ``inversion/ddim.py``, ``methods/base.py`` and
``methods/p2z.py`` import them; pix2pix-zero's ``guided_step_group`` and
``guidance_gradient_group``; ``models/unet.py``'s ``self_attention``) with
wrappers that call the original and:

* keep copies, on the device, of the state at the steps drawn for the
  check (``captures``: a few MB a group); ``missing`` names the hook that
  saw no call where a state the check reads is absent;
* with spans on, record host-clock spans (name, start ns, end ns), the
  spans of the inversion and the edit ending in a device sync;
* with attention recording on, note each self-attention call's shape and
  whether it will be differentiated.

``restore`` puts the originals back.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


def _copy(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone()


class Recorder:
    def __init__(self, steps: int, invert_steps, edit_steps, pass2_steps=()):
        self.steps = steps
        self.invert_steps = sorted(invert_steps)
        self.edit_steps = sorted(edit_steps)
        self.pass2_steps = sorted(pass2_steps)
        self.captures: Dict[int, dict] = {}
        self.group = -1
        self.spans_on = False
        self.spans: List[tuple] = []
        self.attn_on = False
        self.attn_calls: List[tuple] = []
        self.sync = lambda: None
        self._saved = []
        self._stage = None
        self._p2z_step: Optional[int] = None

    # -- bookkeeping ----------------------------------------------------

    def cap(self) -> dict:
        return self.captures.setdefault(self.group, {})

    def span(self, name, fn, *args, sync=False, **kw):
        if not self.spans_on:
            return fn(*args, **kw)
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kw)
        finally:
            if sync:
                self.sync()
            self.spans.append((name, t0, time.perf_counter_ns()))

    def _patch(self, module, name, wrapper):
        orig = getattr(module, name)
        self._saved.append((module, name, orig))
        setattr(module, name, wrapper(orig))

    def restore(self):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()

    # -- the wrappers ---------------------------------------------------

    def install(self):
        from image_editing_framework_torch.eval import batched
        from image_editing_framework_torch.inversion import ddim
        from image_editing_framework_torch.methods import base, p2z
        from image_editing_framework_torch.models import unet

        rec = self

        def invert_batch(orig):
            def f(pipe, latents, prompts, return_trajectory=False):
                out = rec.span("invert", orig, pipe, latents, prompts, return_trajectory, sync=True)
                if return_trajectory:
                    traj = out[1]  # (G, S+1, 1, h, w, 4)
                    c = rec.cap()
                    c["traj"] = [_copy(traj[:, 0, 0]), _copy(traj[:, -1, 0])]
                    for i in rec.invert_steps:
                        c.setdefault("invert", {}).setdefault(i, {}).update(
                            x=_copy(traj[:, i, 0]), next=_copy(traj[:, i + 1, 0]))
                return out
            return f

        def reverse_step(orig):
            def f(sched, eps, step_index, sample):
                if step_index in rec.invert_steps:
                    rec.cap().setdefault("invert", {}).setdefault(step_index, {})["eps"] = _copy(eps)
                return orig(sched, eps, step_index, sample)
            return f

        def edit_batch(orig):
            def f(*a, **kw):
                return rec.span("edit", orig, *a, sync=True, **kw)
            return f

        def denoise_scan(orig):
            def f(*a, **kw):
                pass1 = kw.get("collect_records") or kw.get("collect_trajectory")
                rec._stage = "pass1" if pass1 else "edit"
                try:
                    return rec.span("pass1" if pass1 else "denoise", orig, *a, **kw)
                finally:
                    rec._stage = None
            return f

        def base_step(orig):
            def f(sched, eps, step_index, sample):
                stage = rec._stage or "edit"
                c = rec.cap()
                if step_index == 0:
                    c[stage + "_first"] = _copy(sample)
                out = orig(sched, eps, step_index, sample)
                if step_index in rec.edit_steps:
                    c.setdefault(stage, {})[step_index] = {"x": _copy(sample), "eps": _copy(eps)}
                if step_index - 1 in rec.edit_steps:
                    c[stage][step_index - 1]["next"] = _copy(sample)
                if step_index == rec.steps - 1 and step_index in rec.edit_steps:
                    c[stage][step_index]["next"] = _copy(out)
                if stage == "pass1" and step_index in rec.pass2_steps:
                    c.setdefault("pass1_at", {})[step_index] = _copy(sample)
                return out
            return f

        def guided_scan(orig):
            def f(*a, **kw):
                return rec.span("pass2", orig, *a, **kw)
            return f

        def guided_step(orig):
            def f(unet_fn, sched, i, lat, *a, **kw):
                c = rec.cap()
                if i == 0:
                    c["pass2_first"] = _copy(lat)
                keep = i in rec.pass2_steps

                def unet_seen(x, *ua, **ukw):  # the last call's input is the updated pair
                    c.setdefault("pass2", {}).setdefault(i, {})["x_in"] = _copy(x)
                    return unet_fn(x, *ua, **ukw)

                rec._p2z_step = i
                try:
                    out = orig(unet_seen if keep else unet_fn, sched, i, lat, *a, **kw)
                finally:
                    rec._p2z_step = None
                if keep:
                    c["pass2"][i].update(lat=_copy(lat), next=_copy(out[0]))
                return out
            return f

        def gradient(orig):
            def f(*a, **kw):
                losses, g = orig(*a, **kw)
                if rec._p2z_step in rec.pass2_steps:
                    rec.cap().setdefault("pass2", {}).setdefault(rec._p2z_step, {})["grad"] = _copy(g)
                return losses, g
            return f

        def p2z_step(orig):
            def f(sched, eps, step_index, sample):
                if rec._p2z_step is not None and step_index in rec.pass2_steps:
                    rec.cap().setdefault("pass2", {}).setdefault(step_index, {})["eps"] = _copy(eps)
                return orig(sched, eps, step_index, sample)
            return f

        def decode_pairs(orig):
            def f(pipe, final):
                rec.cap()["final"] = _copy(final)
                return rec.span("decode", orig, pipe, final)
            return f

        def self_attention(orig):
            def f(q, k, v, plan, *a, **kw):
                if rec.attn_on:
                    b, h, nq, d = q.shape
                    grad = torch.is_grad_enabled() and q.requires_grad
                    rec.attn_calls.append((b, h, nq, k.shape[2], d, grad))
                return orig(q, k, v, plan, *a, **kw)
            return f

        self._patch(batched, "ddim_invert_batch", invert_batch)
        self._patch(ddim, "ddim_reverse_step", reverse_step)
        self._patch(batched, "edit_batch", edit_batch)
        self._patch(batched, "_denoise_scan", denoise_scan)
        self._patch(base, "ddim_step", base_step)
        self._patch(batched, "_guided_scan_group", guided_scan)
        self._patch(p2z, "guided_step_group", guided_step)
        self._patch(p2z, "guidance_gradient_group", gradient)
        self._patch(p2z, "ddim_step", p2z_step)
        self._patch(batched, "_decode_pairs", decode_pairs)
        self._patch(unet, "self_attention", self_attention)

    def finish_group(self, method: str):
        """Complete a group's captures: pix2pix-zero's pass-1 latent at each
        pass-2 step joins that step."""
        c = self.captures.get(self.group)
        if not c or method != "p2z":
            return
        for i, st in c.get("pass2", {}).items():
            if i in c.get("pass1_at", {}):
                st["src_x"] = c["pass1_at"][i]

    def missing(self, group: int, method: str) -> List[str]:
        """The states of ``group`` that the check reads and no hook
        recorded, each with the port's name whose call should have."""
        inv, ddim = "eval.batched.ddim_invert_batch", "inversion.ddim.ddim_reverse_step"
        base, dec = "methods.base.ddim_step", "eval.batched._decode_pairs"
        need = [(("traj",), inv), (("final",), dec)]
        for i in self.invert_steps:
            need += [(("invert", i, "x"), inv), (("invert", i, "next"), inv), (("invert", i, "eps"), ddim)]
        stage = "edit" if method == "p2p" else "pass1"
        need.append(((stage + "_first",), base))
        for i in self.edit_steps:
            need += [((stage, i, k), base) for k in ("x", "eps", "next")]
        if method == "p2z":
            need.append((("pass2_first",), "methods.p2z.guided_step_group"))
            for i in self.pass2_steps:
                need += [(("pass2", i, "lat"), "methods.p2z.guided_step_group"),
                         (("pass2", i, "next"), "methods.p2z.guided_step_group"),
                         (("pass2", i, "x_in"), "the UNet callable handed to methods.p2z.guided_step_group"),
                         (("pass2", i, "grad"), "methods.p2z.guidance_gradient_group"),
                         (("pass2", i, "eps"), "methods.p2z.ddim_step"),
                         (("pass2", i, "src_x"), base + " in pass 1")]
        out = []
        for path, hook in need:
            node = self.captures.get(group, {})
            for k in path:
                node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                out.append(f"{'/'.join(map(str, path))} (the hook on {hook} saw no call)")
        return out
