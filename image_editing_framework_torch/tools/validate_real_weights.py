"""One-command real-weight validation: all four methods end to end, golden
image hashes per seed, CLIP / LPIPS / PSNR / SSIM.

Counterpart of the JAX package's ``tools/validate_real_weights.py``: it runs
``eval/validate.py main`` with the same flags, on the card unless the
checkpoint is loaded elsewhere. There is no compilation cache to point
anywhere (the kernels are built once per checkout, ``ops/_cuda.py``). The
default ``--out`` is ``./validation_torch``, so the reports of this package
never land on the JAX package's committed ``validation/`` reports:

    python -m image_editing_framework_torch.tools.validate_real_weights --sd_version 1.5 \\
        --source_image ./test.jpg [--out validation_torch/] \\
        [--clip_checkpoint /ckpts/clip-vit-b32] [--lpips_weights lpips_vgg16.safetensors]

Run again with ``--sd_version xl-base`` (or ``2.1``) for the other tables;
``--random_weights`` writes the seeded golden-hash anchor that
``tools/golden_check.py`` replays.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

DEFAULT_OUT = "./validation_torch"


def main(argv: Optional[Sequence[str]] = None) -> int:
    from image_editing_framework_torch.eval.validate import main as validate_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--out" or a.startswith("--out=") for a in argv):
        argv += ["--out", DEFAULT_OUT]
    validate_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
