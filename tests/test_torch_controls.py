"""The port's framework-free pieces and P2P controls against the JAX
package's: tokenizer, seq_aligner, schedules and ``build_p2p_control``
exactly; ``P2PStep.edit_cross`` / ``record`` within atol 1e-6 (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_torch.core.config import P2PConfig as TP2PConfig
from image_editing_framework_torch.models import tokenizer as ttok
from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_torch.ops import schedules as tsched
from image_editing_framework_torch.ops import seq_aligner as tseq
from image_editing_framework_tpu.core.config import P2PConfig as JP2PConfig
from image_editing_framework_tpu.models import tokenizer as jtok
from image_editing_framework_tpu.ops import attention as jatt
from image_editing_framework_tpu.ops import controls as jctl
from image_editing_framework_tpu.ops import schedules as jsched
from image_editing_framework_tpu.ops import seq_aligner as jseq
from torch_port_helpers import n, t

PROMPTS = {
    "replace": ["a cat sitting on a mat", "a dog sitting on a mat"],
    "refine": ["a cat sitting on a mat", "a fluffy cat sitting on a soft mat"],
}

CASES = [
    ("replace", {}),
    ("refine", {}),
    ("replace", dict(eq_words=("dog",), eq_values=(2.0,), cross_replace_steps={"default_": 0.8, "dog": (0.2, 0.6)})),
]


def _toks():
    return jtok.WordTokenizer(vocab_size=64), ttok.WordTokenizer(vocab_size=64)


def test_tokenizer_and_seq_aligner_equal():
    jt, tt = _toks()
    texts = ["a cat sitting on a mat", "a dog sitting on a mat", "a fluffy cat on a soft mat"]
    np.testing.assert_array_equal(ttok.pad_token_ids(tt, texts), jtok.pad_token_ids(jt, texts))
    assert tt.encode(texts[2]) == jt.encode(texts[2])
    np.testing.assert_array_equal(
        tseq.get_replacement_mapper(texts[:2], tt), jseq.get_replacement_mapper(texts[:2], jt))
    for a, b in zip(tseq.get_refinement_mapper([texts[0], texts[2]], tt),
                    jseq.get_refinement_mapper([texts[0], texts[2]], jt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tseq.get_word_inds(texts[2], "soft", tt), jseq.get_word_inds(texts[2], "soft", jt))
    np.testing.assert_array_equal(
        tseq.get_equalizer(texts[1], ("dog",), (2.0,), tt), jseq.get_equalizer(texts[1], ("dog",), (2.0,), jt))


def test_schedules_equal():
    jt, tt = _toks()
    prompts = PROMPTS["replace"]
    steps = {"default_": (0.0, 0.7), "dog": (0.1, 0.5)}
    np.testing.assert_array_equal(
        tsched.cross_replace_alpha(prompts, 10, dict(steps), tt),
        jsched.cross_replace_alpha(prompts, 10, dict(steps), jt))
    np.testing.assert_array_equal(tsched.self_replace_gate(0.6, 10), jsched.self_replace_gate(0.6, 10))
    np.testing.assert_array_equal(tsched.self_replace_gate((0.2, 0.6), 10), jsched.self_replace_gate((0.2, 0.6), 10))
    words = (("cat",), ("dog",))
    np.testing.assert_array_equal(
        tsched.blend_alpha_layers(prompts, words, tt), jsched.blend_alpha_layers(prompts, words, jt))


@pytest.mark.parametrize("edit_type,extra", CASES)
def test_build_p2p_control_equal(edit_type, extra):
    jt, tt = _toks()
    prompts = PROMPTS[edit_type]
    jc = jctl.build_p2p_control(prompts, jt, 10, JP2PConfig(edit_type=edit_type, **extra), record_blend=True)
    tc = tctl.build_p2p_control(prompts, tt, 10, TP2PConfig(edit_type=edit_type, **extra), record_blend=True)
    for name in ("mapper", "tok_alpha", "equalizer", "cross_alpha", "self_gate"):
        np.testing.assert_array_equal(n(getattr(tc, name)), n(getattr(jc, name)), err_msg=name)
    assert tc.num_prompts == jc.num_prompts and tc.record_blend == jc.record_blend


@pytest.mark.parametrize("edit_type,extra", CASES)
def test_p2p_step_edit_cross_and_record_match(edit_type, extra):
    jt, tt = _toks()
    prompts = PROMPTS[edit_type]
    jc = jctl.build_p2p_control(prompts, jt, 10, JP2PConfig(edit_type=edit_type, **extra), record_blend=True)
    tc = tctl.build_p2p_control(prompts, tt, 10, TP2PConfig(edit_type=edit_type, **extra), record_blend=True)
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 2, 256, 77).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    site_j = jatt.AttnSite(layer=1, place="down", seq_len=256, is_cross=True)
    site_t = tatt.AttnSite(layer=1, place="down", seq_len=256, is_cross=True)
    for i in (0, 5, 9):  # inside and outside the cross-replace window
        js, ts = jc.at_step(i), tc.at_step(i)
        je, te = js.edit_cross(site_j, jnp.asarray(probs)), ts.edit_cross(site_t, t(probs))
        np.testing.assert_allclose(n(te), n(je), atol=1e-6, rtol=0)
        assert ts.record_key(site_t) == js.record_key(site_j) == site_t.key
        np.testing.assert_allclose(n(ts.record(site_t, te)), n(js.record(site_j, je)), atol=1e-6, rtol=0)
        assert ts.self_gate == bool(js.self_gate)
    small = tatt.AttnSite(layer=0, place="down", seq_len=1024, is_cross=True)
    assert tc.at_step(0).record_key(small) is None
    assert tc.at_step(0).self_plan(tatt.AttnSite(0, "down", 1024, False), 4) is None
