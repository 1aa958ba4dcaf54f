"""The port's CLIP text tower (``models/clip.py CLIPTextModel``) against
``transformers.CLIPTextModel`` / ``CLIPTextModelWithProjection``, the
implementation the reference loads its text encoders with.

Each model is built from a config with seeded random weights on the CPU
(nothing is downloaded), at reduced depth and width, in three flavours:
CLIP-L's (quick_gelu, no projection; SD1.x and SDXL's first tower),
OpenCLIP-H's (exact gelu, no projection; SD2.1) and bigG's (exact gelu with
the pooled text projection; SDXL's second tower). The port loads the
transformers model's ``state_dict`` as it is (its keys are transformers'),
and its last hidden state, penultimate hidden state (``hidden_states[-2]``,
what SDXL conditions on) and pooled output (the EOS row, projected where
the tower has a projection) are held to transformers' at 1e-5 in f32.
``eos_token_id=2`` selects transformers' argmax pooling, which the port (as
the JAX package) uses: EOS has the largest id.
"""

import numpy as np
import pytest
import torch
import transformers

from image_editing_framework_torch.models.clip import CLIPTextConfig, CLIPTextModel
from image_editing_framework_torch.models.loader import load_params

ATOL = 1e-5
VOCAB = 100
FLAVOURS = {"clip_l": ("quick_gelu", None), "open_clip_h": ("gelu", None), "open_clip_big_g": ("gelu", 24)}


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_text_tower_matches_transformers(flavour):
    act, projection = FLAVOURS[flavour]
    hf_cfg = transformers.CLIPTextConfig(vocab_size=VOCAB, hidden_size=64, intermediate_size=256,
                                         num_hidden_layers=3, num_attention_heads=4, max_position_embeddings=77,
                                         hidden_act=act, projection_dim=projection or 512, eos_token_id=2)
    torch.manual_seed(0)
    cls = transformers.CLIPTextModelWithProjection if projection else transformers.CLIPTextModel
    hf = cls(hf_cfg).eval()
    port = CLIPTextModel(CLIPTextConfig(vocab_size=VOCAB, hidden_size=64, num_layers=3, num_heads=4,
                                        intermediate_size=256, hidden_act=act, projection_dim=projection))
    load_params(port, hf.state_dict())
    port.eval()

    rng = np.random.RandomState(1)
    ids = rng.randint(0, VOCAB - 1, (3, 77))
    for row, eos in enumerate((5, 40, 76)):
        ids[row, eos] = VOCAB - 1  # the EOS token: the largest id
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        ref = hf(input_ids=ids, output_hidden_states=True)
        out = port(ids)
    pooled = ref.text_embeds if projection else ref.pooler_output
    for name, got, want in (("last_hidden_state", out["last_hidden_state"], ref.last_hidden_state),
                            ("penultimate", out["penultimate"], ref.hidden_states[-2]),
                            ("pooled", out["pooled"], pooled)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0, err_msg=name)
    # the activation matters: the other one moves the output far beyond the tolerance
    other = CLIPTextModel(CLIPTextConfig(vocab_size=VOCAB, hidden_size=64, num_layers=3, num_heads=4,
                                         intermediate_size=256, projection_dim=projection,
                                         hidden_act="gelu" if act == "quick_gelu" else "quick_gelu"))
    load_params(other, hf.state_dict())
    with torch.no_grad():
        assert (other(ids)["last_hidden_state"] - out["last_hidden_state"]).abs().max().item() > 100 * ATOL
