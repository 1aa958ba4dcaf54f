"""The benchmark's arithmetic: attention bounds against the kernel table's
figures, and the FLOP count against an independent count."""

import json
import os

import pytest
import torch
from conftest import REPO, TINY

from perfbench import harness, yardstick
from perfbench.reference import nets


def _cfg(path):
    with open(path) as f:
        return json.load(f)


def _forward_ms(cfg, batch):
    """(operations over the peak, the sum of each call's bound) in ms."""
    sites = nets.self_attention_sites(cfg["unet"], harness.latent_side(cfg))
    work = [yardstick.attn_work(batch, h, n, n, d) for n, h, d in sites]
    return 1e3 * sum(f for f, _ in work) / yardstick.PEAK_BF16, 1e3 * sum(yardstick.bound_s(*w) for w in work)


def test_attention_bounds_match_the_kernel_table():
    """PERF.md's kernel table (``chip_smoke.py attn_work`` / ``bound_ms``,
    operations over the peak): a CFG-4 UNet forward's 16 SD1.5 sites take
    0.495 ms, SDXL's 70 3.040 ms; pix2pix-zero's backward at batch 2 over
    SD1.5's 16 sites 0.372 ms for dQ's three products, so the whole
    backward's five 5/3 of that. Each call's bound is the larger of its
    operations and its bytes, so the sum of bounds is at least the first."""
    sd15 = _cfg(os.path.join(REPO, "perfbench", "configs", "sd15.json"))
    sdxl = _cfg(os.path.join(REPO, "perfbench", "configs", "sdxl.json"))
    assert len(nets.self_attention_sites(sd15["unet"], 64)) == 16
    assert len(nets.self_attention_sites(sdxl["unet"], 128)) == 70
    for cfg, table in ((sd15, 0.495), (sdxl, 3.040)):
        ops, bound = _forward_ms(cfg, 4)
        assert ops == pytest.approx(table, abs=5e-4)
        assert ops <= bound < 1.05 * ops
    sites = nets.self_attention_sites(sd15["unet"], 64)
    bwd = 1e3 * sum(yardstick.bound_s(*yardstick.bwd_work(2, h, n, n, d)) for n, h, d in sites)
    dq_ops = 1e3 * sum(6.0 * 2 * h * n * n * d / yardstick.PEAK_BF16 for n, h, d in sites)
    assert dq_ops == pytest.approx(0.372, abs=5e-4)
    assert dq_ops * 10 / 6 <= bwd < 1.05 * dq_ops * 10 / 6


def _analytic_unet_flops(cfg, side):
    """2 x in x out per output position for every convolution and linear,
    and 4 x N x M x C for each attention site's two products, walked over
    the weight keys."""
    u = cfg["unet"]
    levels = len(u["block_out_channels"])
    shapes = nets.unet_shapes(u)
    total = 0.0

    def res(key):
        parts = key.split(".")
        if parts[0] == "down_blocks":
            i = int(parts[1])
            return side >> (i + 1) if parts[2] == "downsamplers" else side >> i
        if parts[0] == "up_blocks":
            lvl = levels - 1 - int(parts[1])
            return side >> (lvl - 1) if parts[2] == "upsamplers" else side >> lvl
        if parts[0] == "mid_block":
            return side >> (levels - 1)
        return side

    for key, shape in shapes.items():
        if not key.endswith(".weight") or len(shape) == 1:
            continue
        if "time_embedding" in key or "time_emb_proj" in key:
            total += 2 * shape[0] * shape[1]
            continue
        r = res(key)
        if len(shape) == 4:
            total += 2 * shape[0] * shape[1] * shape[2] * shape[3] * r * r
        else:
            tokens = 77 if ".attn2.to_k" in key or ".attn2.to_v" in key else r * r
            total += 2 * shape[0] * shape[1] * tokens
            if key.endswith(".attn1.to_q.weight"):
                total += 4 * r * r * r * r * shape[0]
            if key.endswith(".attn2.to_q.weight"):
                total += 4 * r * r * 77 * shape[0]
    return total


@pytest.mark.parametrize("path", [os.path.join(TINY, "sd.json"), os.path.join(REPO, "perfbench", "configs", "sd15.json")])
def test_flop_count_matches_an_independent_count(path):
    cfg = _cfg(path)
    side = harness.latent_side(cfg)
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta) for k, s in nets.unet_shapes(cfg["unet"]).items()}
    counted = yardstick.count_flops(lambda: nets.unet(
        params, cfg["unet"], torch.empty(1, 4, side, side, device=meta), 1,
        torch.empty(1, 77, cfg["unet"]["cross_attention_dim"], device=meta)))
    assert counted == pytest.approx(_analytic_unet_flops(cfg, side), rel=1e-9)
