"""DDIM scheduler: precomputed tables and step functions.

Counterpart of ``image_editing_framework_tpu/core/scheduler.py``. The
reference configures a diffusers ``DDIMScheduler`` with
``beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
num_train_timesteps=1000, steps_offset=1, clip_sample=False,
set_alpha_to_one=False`` (p2p/edit_real.py:58-69).

The tables stay on the host in f32, as JAX keeps them. A step reads its
coefficients there as Python numbers, rounded through the sample's dtype in
the order JAX computes them, so the device loop never waits on a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Immutable DDIM schedule tables.

    Attributes:
      alphas_cumprod: (num_train_timesteps,) f32 cumulative alpha products.
      final_alpha_cumprod: 0-d f32; ``alphas_cumprod[0]`` (set_alpha_to_one=False).
      timesteps: (num_steps,) int64, descending (e.g. [981, 961, ..., 1]).
    """

    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor
    timesteps: torch.Tensor
    num_train_timesteps: int
    num_steps: int

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_steps


def make_ddim_schedule(
    num_steps: int,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    steps_offset: int = 1,
    set_alpha_to_one: bool = False,
) -> DDIMSchedule:
    """Build the DDIM schedule matching the reference's scheduler config."""
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta_schedule: {beta_schedule}")
    alphas_cumprod = torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))
    final = torch.tensor(1.0) if set_alpha_to_one else alphas_cumprod[0].clone()
    step_ratio = num_train_timesteps // num_steps
    # diffusers "leading" spacing with steps_offset: [0, r, 2r, ...] reversed + offset.
    timesteps = torch.arange(num_steps - 1, -1, -1, dtype=torch.int64) * step_ratio + steps_offset
    return DDIMSchedule(alphas_cumprod, final, timesteps, num_train_timesteps, num_steps)


def _alpha(sched: DDIMSchedule, t: int) -> torch.Tensor:
    return sched.alphas_cumprod[t] if t >= 0 else sched.final_alpha_cumprod


def _coefficients(alpha_src: torch.Tensor, alpha_dst: torch.Tensor, dtype: torch.dtype):
    """Python-number coefficients of x_dst = a * x_src + b * eps, kept apart
    as JAX computes them: pred_x0 = (x - sqrt(1-a_s) eps) / sqrt(a_s), then
    x' = sqrt(a_d) pred_x0 + sqrt(1-a_d) eps, each scalar in ``dtype``."""
    a_s, a_d = alpha_src.to(dtype), alpha_dst.to(dtype)
    return (
        torch.sqrt(1.0 - a_s).item(),
        torch.sqrt(a_s).item(),
        torch.sqrt(a_d).item(),
        torch.sqrt(1.0 - a_d).item(),
    )


def _step(sample, eps, coeffs):
    s1a, sa, sd, s1d = coeffs
    pred_x0 = (sample - s1a * eps) / sa
    return sd * pred_x0 + s1d * eps


def ddim_step(sched: DDIMSchedule, eps: torch.Tensor, step_index: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta=0) DDIM denoising step x_t -> x_{t-Δ}.

    ``step_index`` indexes ``sched.timesteps`` (0 = most-noised). Matches
    diffusers DDIMScheduler.step with prediction_type="epsilon",
    clip_sample=False, eta=0 (reference call site: p2p/model/sd_utils.py:76).
    """
    t = int(sched.timesteps[step_index])
    coeffs = _coefficients(_alpha(sched, t), _alpha(sched, t - sched.step_ratio), sample.dtype)
    return _step(sample, eps, coeffs)


def ddim_reverse_step(sched: DDIMSchedule, eps: torch.Tensor, step_index: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM *inversion* step x_{t-Δ} -> x_t.

    Mirrors the reference's closed-form reverse step
    (p2p/inversion/ddim.py:9-18): inverting toward ``t_next =
    timesteps[S-1-i]`` evaluates the UNet at ``t_next`` on the current
    sample, from source timestep ``t_next - step_ratio`` (the final alpha
    when negative).
    """
    t_next = inversion_timestep(sched, step_index)
    coeffs = _coefficients(_alpha(sched, t_next - sched.step_ratio), _alpha(sched, t_next), sample.dtype)
    return _step(sample, eps, coeffs)


def inversion_timestep(sched: DDIMSchedule, step_index: int) -> int:
    """Timestep fed to the UNet at inversion iteration ``step_index``."""
    return int(sched.timesteps[sched.num_steps - 1 - step_index])


def add_noise(sched: DDIMSchedule, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) at timestep ``t``."""
    alpha = sched.alphas_cumprod[t].to(x0.dtype)
    return torch.sqrt(alpha).item() * x0 + torch.sqrt(1.0 - alpha).item() * noise


def scale_model_input(sample: torch.Tensor, t) -> torch.Tensor:
    """DDIM needs no input scaling; the identity, for the API of schedulers
    that do (reference: pnp/model/sd_utils.py:94 calls
    ``scheduler.scale_model_input``)."""
    del t
    return sample
