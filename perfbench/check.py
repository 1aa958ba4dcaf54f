"""The comparison that decides ``correct``.

The timed path leaves, for every group of the window, copies of its state
at the steps drawn from the seed (``Captures``), the final latents it
decoded, and the PNGs it saved. After the window one group, drawn from the
seed, is judged image by image against the plain reference in float32
(TF32 off), stage by stage from the program's own state at each drawn step
(a 50-step trajectory amplifies rounding into a different image, so only a
step can be held to a tolerance):

* ``encode_rel``: the program's VAE latent of the source image against the
  reference's encode of the same JPEG;
* ``<stage>_eps_rel``: the noise the program's step consumed (guided for
  the edit) against the reference UNet's at the same latent, prompts and
  edit control, for the stages ``invert``, ``edit`` (P2P) or ``pass1``,
  ``pass2`` (pix2pix-zero); ``invert_eps_rms`` the inversion's gap per
  element (the noise's norm moves with the seed's weights, the gap less);
* ``<stage>_state_rel``: the state the program carried into the next step
  against the DDIM update of its own latent and noise, with the coefficients
  the framework states for the state's dtype (the schedule's alphas rounded
  to it first), evaluated in float32: a program that rounds every operation
  to its dtype reads that rounding, one that fuses the update or computes
  it in float32 less, a state left unchanged about a step's move;
* ``grad_rel_pooled``: pix2pix-zero's guidance gradient on the conditional
  row (through the backward attention kernels) against the reference's
  autograd gradient, the reference maps made again from the program's
  pass-1 latent, the gap's norm over all judged images and steps together
  over the reference's;
* ``pass2_update_rel``: pix2pix-zero's updated pair (the latent the noise
  is taken at) against ``lat - 0.1 g`` in float32 from the program's latent
  and gradient, relative to the update ``0.1 g`` (a step left out reads 1;
  with the benchmark's weights the update is under the bf16 latent's
  rounding, so a sound run reads 1 as well and no cell compares it);
* ``handoff_abs``: the inverted latent against the edit's first input
  (exact);
* ``decode_levels``: each saved PNG against the reference's decode of the
  latent the program decoded, mean absolute difference in levels.

Each number is the largest over the judged images and steps
(``<stage>_state_rel_median`` the median); a cell's limits file names the
numbers it compares. The control
(``precision="fp8"``) puts the reference at float8 in the program's place:
its outputs and its gradient at the same states (e4m3 operands, e5m2
gradients), its state updates with float8 coefficients, every operation
rounded to float8.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import editing
from perfbench.reference.nets import Precision

# pix2pix-zero's step size (sd_utils.py: guidance_amount=0.1), which the
# program keeps as its own constant; its cross-attention maps are recorded in
# bfloat16 by the framework's definition (every step's maps stay resident)
GUIDANCE_AMOUNT = 0.1
MAP_DTYPE = torch.bfloat16

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """Root-mean-square gap, per element."""
    return float((a.float() - b.float()).square().mean().sqrt())


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def read_source(path: str, side: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB").resize((side, side)))


class Judge:
    """Numbers of one group of the window; ``precision`` "f32" judges the
    program, "fp8" the control in its place."""

    def __init__(self, model: editing.Model, sch: editing.Schedule, method: str, guidance: float,
                 state_dtype: torch.dtype, precision: str = "f32"):
        self.m, self.sch, self.method, self.cfg_scale = model, sch, method, guidance
        self.state_dtype = state_dtype
        self.lr = GUIDANCE_AMOUNT
        self.ref = Precision("f32")
        self.ctl = precision == "fp8"
        self.q = Precision(precision)
        self.numbers: Dict[str, List[float]] = {}
        self.detail: List[dict] = []  # per image and step, for calibration
        self.gaps: List[tuple] = []  # pix2pix-zero: (|gap|^2, |reference|^2) per image and step

    def put(self, name: str, value: float):
        self.numbers.setdefault(name, []).append(float(value))

    def state(self, x: torch.Tensor) -> torch.Tensor:
        """A state as the judged side stores it."""
        return self.q(x) if self.ctl else x

    def result(self) -> Dict[str, float]:
        """The largest of each number over the judged images and steps; for
        the carried states also the median, and for pix2pix-zero's gradient
        only the gap over all images and steps together: their largest
        swings with the steps the seed draws (the first, high-noise steps
        cancel in bf16; the earliest pass-2 steps' maps differ least), far
        more than with the program's precision."""
        out = {k: max(v) for k, v in self.numbers.items() if k != "grad_rel"}
        for k, v in self.numbers.items():
            if k.endswith("_state_rel"):
                out[k + "_median"] = float(np.median(v))
        if self.gaps:
            out["grad_rel_pooled"] = (sum(a for a, _ in self.gaps) / max(sum(b for _, b in self.gaps), 1e-30)) ** 0.5
        return out

    # -- one image ------------------------------------------------------

    def image(self, cap: dict, gi: int, item: dict, paths: dict):
        dev = self.m.device
        src, tgt = item["source"], item["target"]
        side = self.m.cfg["resolution"]
        img = torch.as_tensor(read_source(paths["source"], side), device=dev)[None]
        z_ref = self.m.encode(img)
        z = self.m.encode(img, self.q) if self.ctl else _nchw(cap["traj"][0][gi:gi + 1])
        self.put("encode_rel", _rel(z, z_ref))

        ctx_src, pooled_src = self.m.conditioning([src])
        for i, st in cap["invert"].items():
            x = _nchw(st["x"][gi:gi + 1])
            eps_ref = self.m.eps(x, editing.invert_timestep(self.sch, i), ctx_src, pooled_src)
            eps = self.m.eps(x, editing.invert_timestep(self.sch, i), ctx_src, pooled_src, q=self.q) \
                if self.ctl else _nchw(st["eps"][gi:gi + 1])
            self.put("invert_eps_rel", _rel(eps, eps_ref))
            self.put("invert_eps_rms", _rms(eps, eps_ref))
            self.detail.append({"name": "invert_eps_rel", "image": gi, "step": i, "value": _rel(eps, eps_ref),
                                "eps_norm": float(eps_ref.norm()), "x_norm": float(x.norm()),
                                "err_norm": float((eps - eps_ref).norm())})
            self.transition("invert_state_rel", x, eps, editing.step_alphas(self.sch, i, True),
                            _nchw(st["next"][gi:gi + 1]))

        inverted = _nchw(cap["traj"][-1][gi:gi + 1])
        if self.method == "p2p":
            self._p2p(cap, gi, src, tgt, inverted)
        else:
            self._p2z(cap, gi, src, tgt, inverted)

        final = _nchw(cap["final"][gi])  # (2, 4, h, w): reconstruction, edit
        ref_img = self.m.decode(final)
        out = self.m.decode(final, self.q).round() if self.ctl else None
        for row, name in enumerate(("inversion", "edit")):
            got = out[row] if self.ctl else torch.as_tensor(_read_png(paths[name]), device=dev).float()
            self.put("decode_levels", float((got - ref_img[row].round()).abs().mean()))

    def transition(self, name: str, x: torch.Tensor, eps: torch.Tensor, alphas, nxt: torch.Tensor):
        """The state carried into the next step (``nxt``, the program's)
        against the DDIM update of the judged latent and noise with the
        framework's coefficients for the state's dtype, in float32. The
        control stores its state in float8 and updates it with float8
        coefficients, rounding every operation to float8."""
        if self.ctl:
            x = self.q(x)
            nxt = editing.move_with(x, eps, editing.coefficients(*alphas, editing.to_dtype(torch.float8_e4m3fn)),
                                    self.q)
        want = editing.move_with(x, eps, editing.coefficients(*alphas, editing.to_dtype(self.state_dtype)))
        self.put(name, _rel(nxt, want))

    def _handoff(self, first: torch.Tensor, inverted: torch.Tensor):
        got = self.state(inverted).expand_as(first) if self.ctl else first
        self.put("handoff_abs", float((got - inverted.expand_as(got)).abs().max()))

    def _steps(self, stage: str, cap_stage: dict, gi: int, eps_fn):
        for i, st in cap_stage.items():
            x = _nchw(st["x"][gi])
            eps_ref = eps_fn(x, i, self.ref)
            eps = eps_fn(x, i, self.q) if self.ctl else _nchw(st["eps"][gi])
            self.put(f"{stage}_eps_rel", _rel(eps, eps_ref))
            self.transition(f"{stage}_state_rel", x, eps, editing.step_alphas(self.sch, i, False),
                            _nchw(st["next"][gi]))

    def _cfg_eps(self, x_rows: torch.Tensor, t: int, ctx: torch.Tensor, pooled, hooks, q) -> torch.Tensor:
        """Guided noise of P branches: rows [u x P, c x P]."""
        p = x_rows.shape[0]
        eps = self.m.eps(torch.cat([x_rows, x_rows]), t, ctx, pooled, hooks, q)
        return eps[:p] + self.cfg_scale * (eps[p:] - eps[:p])

    def _p2p(self, cap, gi, src, tgt, inverted):
        steps = len(self.sch.timesteps)
        edit = editing.P2PEdit.build(src, tgt, self.m.tok, steps, self.m.device)
        u_ctx, u_pool = self.m.uncond()
        c_ctx, c_pool = self.m.conditioning([src, tgt])
        ctx = torch.cat([u_ctx.expand(2, -1, -1), c_ctx])
        pooled = None if c_pool is None else torch.cat([u_pool.expand(2, -1), c_pool])
        first = cap["edit_first"]
        self._handoff(_nchw(first[gi]), inverted)

        def eps_fn(x, i, q):
            return self._cfg_eps(x, int(self.sch.timesteps[i]), ctx, pooled, edit.hooks(i), q)

        self._steps("edit", cap["edit"], gi, eps_fn)

    def _p2z(self, cap, gi, src, tgt, inverted):
        u_ctx, u_pool = self.m.uncond()
        s_ctx, s_pool = self.m.conditioning([src])
        t_ctx, t_pool = self.m.conditioning([tgt])
        ctx_s, ctx_t = torch.cat([u_ctx, s_ctx]), torch.cat([u_ctx, t_ctx])
        pool_s = None if s_pool is None else torch.cat([u_pool, s_pool])
        pool_t = None if t_pool is None else torch.cat([u_pool, t_pool])
        self._handoff(_nchw(cap["pass1_first"][gi]), inverted)
        self._handoff(_nchw(cap["pass2_first"][gi]), inverted)

        def eps_src(x, i, q):
            return self._cfg_eps(x, int(self.sch.timesteps[i]), ctx_s, pool_s, None, q)

        self._steps("pass1", cap["pass1"], gi, eps_src)

        for i, st in cap["pass2"].items():
            t = int(self.sch.timesteps[i])
            src_x = _nchw(st["src_x"][gi]).repeat(2, 1, 1, 1)
            lat = _nchw(st["lat"][gi]).repeat(2, 1, 1, 1)
            rec = editing.RecordCross(MAP_DTYPE)
            self.m.eps(src_x, t, ctx_s, pool_s, rec)
            _, g_ref = editing.p2z_gradient(self.m, lat, t, ctx_t, pool_t, rec.maps, store=MAP_DTYPE)
            if self.ctl:
                rec_c = editing.RecordCross(MAP_DTYPE)
                self.m.eps(src_x, t, ctx_s, pool_s, rec_c, self.q)
                _, g = editing.p2z_gradient(self.m, lat, t, ctx_t, pool_t, rec_c.maps, self.q, MAP_DTYPE)
                lat = self.q(lat)
                x_in = self.q(lat - self.q(self.lr * g))
            else:
                g = _nchw(st["grad"][2 * gi:2 * gi + 2])
                x_in = _nchw(st["x_in"][2 * gi:2 * gi + 2])
            # the conditional row: the unconditional one sees the same prompt in
            # both passes, so its maps' distance, and its gradient, is rounding
            self.put("grad_rel", _rel(g[1], g_ref[1]))
            self.gaps.append((float((g[1] - g_ref[1]).square().sum()), float(g_ref[1].square().sum())))
            self.put("pass2_update_rel", _rel(x_in - lat, -self.lr * g))
            self.detail.append({"name": "pass2_update", "image": gi, "step": i,
                                "update_over_state": float((self.lr * g).norm() / lat.norm()),
                                "update_over_state_cond": float((self.lr * g[1]).norm() / lat[1].norm())})
            eps_ref = self.m.eps(x_in, t, ctx_t, pool_t)
            eps_ref = eps_ref[:1] + self.cfg_scale * (eps_ref[1:] - eps_ref[:1])
            if self.ctl:
                e = self.m.eps(x_in, t, ctx_t, pool_t, q=self.q)
                eps = e[:1] + self.cfg_scale * (e[1:] - e[:1])
            else:
                eps = _nchw(st["eps"][gi])
            self.put("pass2_eps_rel", _rel(eps, eps_ref))
            # the step takes the updated pair's first half (sd_utils.py:180)
            self.transition("pass2_state_rel", x_in[:1], eps, editing.step_alphas(self.sch, i, False),
                            _nchw(st["next"][gi]))


def judge_group(judge: Judge, cap: dict, items: List[dict], paths: List[dict]) -> Dict[str, float]:
    with torch.no_grad():
        for gi, (item, p) in enumerate(zip(items, paths)):
            judge.image(cap, gi, item, p)
    return judge.result()


def verdict(numbers: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, [(name, value, limit)]): the numbers the cell's limits name
    are compared, each at or under its limit; a limit without its number,
    or a run that recorded a missing state, is not correct."""
    if not limits:
        return False, [(k, v, None) for k, v in sorted(numbers.items())]
    rows = [(k, numbers.get(k), limits[k]) for k in sorted(limits)]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and "missing_state" not in numbers, rows
