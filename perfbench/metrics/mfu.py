"""Model FLOPs of the profiled group (text towers, VAE, every UNet forward
and pix2pix-zero's backward to the latent, counted over the reference at
the cell's shapes) over the group's wall time at the bf16 peak, in %."""

from perfbench.yardstick import PEAK_BF16


def read(run):
    if run.capture is None or run.capture.wall_s <= 0:
        return None
    return 100.0 * run.flops_per_group / (run.capture.wall_s * PEAK_BF16)
