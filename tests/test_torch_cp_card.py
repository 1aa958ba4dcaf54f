"""Context parallelism on the card: the ring, Ulysses and the ring's
backward at SDXL's and SD1.5's 4096-token sites, on 2 rank processes over
gloo on one card, against the unsharded kernels and the plain versions,
with both planted faults of the ring's backward rejected and every launch
count exact: ``chip_smoke.py``'s ``cp_path`` part (a), whose ranks check
every gate themselves (``cp_kernel_checks``).

Imports only torch, the port and chip_smoke.py (which imports no JAX), so
it runs on the GPU machine, which has no JAX:

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_cp_card.py

Without a card the test skips (tests/test_torch_ring_attention.py holds the
same functions against JAX on CPU ranks).
"""

import importlib.util
import os

import pytest
import torch

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


@pytest.mark.cuda
def test_ring_and_its_backward_on_two_ranks_of_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ranks = smoke.cp_group(2, str(tmp_path), parts="a")
    assert [res["rank"] for res in ranks] == [0, 1]
    for res in ranks:
        names = [row["name"] for row in res["kernels"]["forward"]]
        assert {"xl_ring_bfloat16", "xl_ulysses_bfloat16", "sd_ring_bfloat16", "xl_ring_union_8192"} <= set(names)
        assert [row["launches"] for row in res["kernels"]["backward"]] == [[2, 2]] * 4
