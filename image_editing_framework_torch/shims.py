"""The per-method editing scripts of the reference, as one table.

Counterpart of the ``p2p/``, ``masactrl/``, ``pnp/`` and ``pix2pix-zero/``
``edit_real.py`` / ``edit_syn.py`` / ``test.py`` scripts (which stay the JAX
package's): each entry holds what its script passes to ``cli.edit_real_main``,
``cli.edit_syn_main`` or ``cli.test_main``: the method, its defaults and its
``method_kwargs``.

Run from any directory (the edits' images go to ``./exp``, the PIE-Bench
sweep's to ``--exp_path``)::

    python -m image_editing_framework_torch.shims p2p edit_real --sd_version 1.5 --source_image x.png
    python -m image_editing_framework_torch.shims pnp edit_syn --seed 7
    python -m image_editing_framework_torch.shims p2p test --sd_version 1.5 --dataset_path PIE --exp_path out

after pointing ``image_editing_framework_torch/sd_mapping.py`` at a local
checkpoint.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

from image_editing_framework_torch.core.config import P2PConfig, PnPConfig

# (script directory, entry) -> (method, keyword arguments of the entry)
SHIMS: Dict[Tuple[str, str], Tuple[str, dict]] = {
    # p2p parameters (reference: p2p/edit_real.py:49-51, p2p/edit_syn.py:41-42)
    ("p2p", "edit_real"): ("p2p", dict(method_kwargs={"config": P2PConfig(
        edit_type="refine", cross_replace_steps=0.8, self_replace_steps=0.6)})),
    ("p2p", "edit_syn"): ("p2p", dict(method_kwargs={"config": P2PConfig(
        edit_type="refine", cross_replace_steps=0.8, self_replace_steps=0.4)})),
    # MasaCtrl's STEP 4 / LAYER 10 (54 on SDXL) are default_masactrl_config's
    # (reference: masactrl/edit_real.py:48-49, :118)
    ("masactrl", "edit_real"): ("masactrl", {}),
    ("masactrl", "edit_syn"): ("masactrl", dict(
        default_source="A standing dog on the grass field", default_target="A running dog on the grass field")),
    # pnp parameters (reference: pnp/edit_real.py:45-46; edit_syn's joint call
    # with full-strength injection, pnp/edit_syn.py:39-40)
    ("pnp", "edit_real"): ("pnp", dict(default_inversion="ddim",
                                       method_kwargs={"config": PnPConfig(pnp_attn_t=0.5, pnp_f_t=0.8)})),
    ("pnp", "edit_syn"): ("pnp", dict(
        default_source=("A crisp, juicy green apple sits perched on a wooden table, its smooth surface glistening "
                        "in the light"),
        default_target=("A crisp, juicy red apple sits perched on a wooden table, its smooth surface glistening "
                        "in the light"),
        method_kwargs={"config": PnPConfig(pnp_attn_t=1.0, pnp_f_t=1.0)})),
    ("p2z", "edit_real"): ("p2z", dict(
        default_source="a round cake with orange frosting on a wooden plate",
        default_target="a square cake with orange frosting on a wooden plate")),
    ("p2z", "edit_syn"): ("p2z", dict(
        default_source="A photo of a cool boy with blue trousers",
        default_target="A photo of a cool boy with yellow trousers")),
    # the PIE-Bench sweeps: each test.py calls test_main(method) alone
    # (reference: p2p/test.py, masactrl/test.py, pnp/test.py, pix2pix-zero/test.py)
    ("p2p", "test"): ("p2p", {}),
    ("masactrl", "test"): ("masactrl", {}),
    ("pnp", "test"): ("pnp", {}),
    ("p2z", "test"): ("p2z", {}),
}
ENTRIES = {"edit_real": "edit_real_main", "edit_syn": "edit_syn_main", "test": "test_main"}


def main(argv=None) -> None:
    """``<p2p|masactrl|pnp|p2z> <edit_real|edit_syn|test> [the entry's flags]``."""
    from image_editing_framework_torch import cli

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or tuple(argv[:2]) not in SHIMS:
        raise SystemExit(f"usage: python -m image_editing_framework_torch.shims "
                         f"<{'|'.join(sorted({k[0] for k in SHIMS}))}> <{'|'.join(ENTRIES)}> [flags]")
    method, kwargs = SHIMS[argv[0], argv[1]]
    getattr(cli, ENTRIES[argv[1]])(method, argv=argv[2:], **kwargs)


if __name__ == "__main__":
    main()
