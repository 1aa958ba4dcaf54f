"""``tools/group_drift.py row_dependence`` on the tiny SD pipeline on the
CPU: every leaf module and attention call of one UNet forward is rerun on
equal rows and on the first row alone; in f32 none of them makes a row
depend on its place in the batch, none but the library's GEMMs and
convolutions gives its first row other bits than at batch 1, and a
planted fault (an attention function's or a module's result that
depends on a row's place, or on the batch's size) is named and nothing
else is.
"""

import pytest
import torch

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)
from image_editing_framework_torch.models import unet as unet_module
from image_editing_framework_torch.ops import group_norm
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.tools.group_drift import ATTENTION_CALLS, row_dependence

BATCH = 3


@pytest.fixture(scope="module")
def pipe():
    return tiny_pipeline(num_steps=4, device="cpu")


def _by_row(x):
    """x plus 1e-3 times its row's index: a result that depends on where
    the row sits in the batch."""
    return x + 1e-3 * torch.arange(x.shape[0], dtype=x.dtype).view(-1, *[1] * (x.dim() - 1))


def _by_size(x):
    """x plus 1e-3 times the batch's size: a result that depends on how
    many rows the call was given."""
    return x + 1e-3 * x.shape[0]


def _plant(monkeypatch, where, fault):
    if where == "cross_attention_probs":
        real = unet_module.cross_attention_probs
        monkeypatch.setattr(unet_module, "cross_attention_probs", lambda q, k: fault(real(q, k)))
    elif where == "GroupNorm":  # the UNet's GroupNorm modules, SiLU fused in where asked
        real = group_norm.GroupNorm.forward
        monkeypatch.setattr(group_norm.GroupNorm, "forward", lambda self, x, silu=False: fault(real(self, x, silu)))


@pytest.mark.parametrize("where,fault,kind", [
    (None, None, None),
    ("cross_attention_probs", _by_row, "row_dependent"),
    ("GroupNorm", _by_row, "row_dependent"),
    ("GroupNorm", _by_size, "batch_dependent"),
])
def test_row_dependence_names_the_position_dependent_call(pipe, monkeypatch, where, fault, kind):
    _plant(monkeypatch, where, fault)
    before = {name: getattr(unet_module, name) for name in ATTENTION_CALLS}
    got = row_dependence(pipe, BATCH, side=8)
    assert got["dtype"] == "float32" and got["batch"] == BATCH
    assert set(got["calls"]) == {"Linear", "Conv2d", "GroupNorm", "LayerNorm", *ATTENTION_CALLS}
    assert all(n > 0 for n in got["calls"].values())
    # in f32 on the CPU no call makes a row depend on its place; the
    # library's GEMMs and convolutions may round otherwise at batch 1 (they
    # do here), the plain calls may not
    if kind != "row_dependent":
        assert got["row_dependent"] == {}
    else:
        assert list(got["row_dependent"]) == [where]
    unplanted = set(got["batch_dependent"]) - ({where} if kind == "batch_dependent" else set())
    assert unplanted <= {"Linear", "Conv2d"}, unplanted
    if kind is not None:
        assert all(shape[0] == BATCH for shape in got[kind][where])
    # the attention functions are put back as they were
    assert {name: getattr(unet_module, name) for name in ATTENTION_CALLS} == before
