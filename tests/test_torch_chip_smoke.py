"""chip_smoke.py refuses to report a result where it cannot run the port on
a card: with no CUDA device visible, and from a directory that holds the
script and nothing else of the repository."""

import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run(SCRIPT, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    out = _run(str(lone), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _load_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # importing it runs nothing: main() is behind the __main__ check
    return module


def test_chip_smoke_builds_every_kernel_source():
    """Every CUDA source of the port is in SOURCES, so the script alone
    builds them all (one nvcc each, started together)."""
    smoke = _load_script()
    csrc = os.path.join(ROOT, "image_editing_framework_torch", "csrc")
    on_disk = sorted(name[:-3] for name in os.listdir(csrc) if name.endswith(".cu"))
    assert sorted(smoke.SOURCES) == on_disk and "mma_probe" in smoke.SOURCES


def test_chip_smoke_wires_every_phase_into_main():
    """main() runs the earlier phases and the later slices': the probe, both
    models' main, NTI, profile, MasaCtrl, PnP and pix2pix-zero phases, and
    the refiner; the kernels line names all four kernels, the forward's
    biased figures and the backward's at p2z's batch; the XL shapes are
    SDXL's 70 sites at head dim 64."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    for phase in ("phase_device", "phase_kernels", "phase_bwd_kernels", "phase_probe", "phase_tiny",
                  "phase_main_path", "phase_checkpoint_path", "phase_sweep_path", "phase_xl_checkpoint_path",
                  "phase_nti_path", "phase_profile", "phase_masactrl_path", "phase_pnp_path", "phase_p2z_path",
                  "phase_refiner", "phase_group_norm"):
        assert callable(getattr(smoke, phase)) and phase in source, phase
    assert '("sd", ""), ("xl", "xl_")' in source  # both models go through main, NTI and profile
    for kernel in ("flash_fwd", "flash_bwd_", "mma_probe", "group_norm_nhwc"):
        assert f'"name": "{kernel}' in source or f'"name": f"{kernel}' in source, kernel
    assert smoke.PATH_SHAPES["xl"] == [(4096, 64, 10, 10), (1024, 64, 20, 60)]
    assert smoke.SITES == {"sd": 16, "xl": 70, "sd21": 16} and smoke.GRAD_SITES == {"sd": 15, "xl": 69, "sd21": 15}
    assert smoke.PATH_SHAPES["sd"][0] == (4096, 40, 8, 5)  # the SD1.5 shapes stay
    assert "xl_tiny" in inspect.getsource(smoke.phase_tiny) and "tiny_edits" in inspect.getsource(smoke.phase_tiny)
    assert '"at_bias"' in source and '"masactrl_path": launches["masactrl"]' in source
    assert '"at_p2z"' in source and '"p2z_path": launches["p2z"]' in source and '"xl_p2z_path"' in source
    # the checkpoint phase runs on SD1.5 between its main path and its NTI path, and its launches count
    assert source.index("phase_checkpoint_path") < source.index("phase_nti_path")
    assert '"checkpoint_path": launches["checkpoint"]' in source
    # the sweep reads the SD1.5 snapshot after the checkpoint phase, in the same directory; the SDXL
    # checkpoints follow the SDXL main path; both phases' launches count
    assert source.index("phase_checkpoint_path") < source.index("phase_sweep_path") < source.index("phase_nti_path")
    assert source.index("phase_main_path") < source.index("phase_xl_checkpoint_path") < source.index("phase_nti_path")
    assert '"sweep_path": launches["sweep"]' in source and '"xl_checkpoint_path": launches["xl_checkpoint"]' in source
    # the biased shapes: union doubles the gated sites' keys, mask keeps them
    assert sum(calls for v, *_, calls in smoke.BIAS_SHAPES["sd"] if v == "union") == 6
    assert sum(calls for v, *_, calls in smoke.BIAS_SHAPES["xl"] if v == "union") == 16
    for shapes in smoke.BIAS_SHAPES.values():
        for variant, n, nk, d, h, calls in shapes:
            assert nk == (2 * n if variant == "union" else n)
    last = source.rstrip().splitlines()
    assert '"ok": True' in "".join(last[-4:])  # the result object is printed last


def _source_constant(name, constant):
    import re

    with open(os.path.join(ROOT, "image_editing_framework_torch", "csrc", name)) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {constant} = (\d+);", text).group(1)), text


def test_chip_smoke_key_tiles_are_the_kernels():
    """The planted faults emulate tiles of the kernels they check, read from
    the CUDA sources: the forward's key tiles (128 up to d = 80, 64 at
    d = 160), the dQ kernel's key tiles (128, 64 at d = 160) and the dK/dV
    kernel's query tiles (64, 32 at d = 160)."""
    smoke = _load_script()
    fwd, fwd_text = _source_constant("flash_fwd.cu", "kBK")
    wide, _ = _source_constant("flash_fwd.cu", "kBKWide")
    dq, bwd_text = _source_constant("flash_bwd.cu", "kDqBK")
    dq_wide, _ = _source_constant("flash_bwd.cu", "kDqBKWide")
    dkv, _ = _source_constant("flash_bwd.cu", "kDkvBQ")
    dkv_wide, _ = _source_constant("flash_bwd.cu", "kDkvBQWide")
    assert (smoke.FWD_KEY_TILE, smoke.FWD_KEY_TILE_WIDE) == (fwd, wide)
    assert (smoke.BWD_DQ_KEY_TILE, smoke.BWD_DQ_KEY_TILE_WIDE) == (dq, dq_wide)
    assert (smoke.BWD_DKV_QUERY_TILE, smoke.BWD_DKV_QUERY_TILE_WIDE) == (dkv, dkv_wide)
    assert "DP > 80 ? kBKWide : kBK" in fwd_text
    assert "DP > 80 ? kDqBKWide : kDqBK" in bwd_text and "DP > 80 ? kDkvBQWide : kDkvBQ" in bwd_text
    assert [smoke.fwd_key_tile(d) for d in (16, 40, 64, 80, 160)] == [fwd] * 4 + [wide]
    assert [smoke.bwd_dq_key_tile(d) for d in (16, 40, 64, 80, 160)] == [dq] * 4 + [dq_wide]
    assert [smoke.bwd_dkv_query_tile(d) for d in (16, 40, 64, 80, 160)] == [dkv] * 4 + [dkv_wide]


@pytest.mark.parametrize("nq,nk,d", [(200, 300, 64), (130, 200, 160)])
def test_planted_faults_exceed_the_limit_at_the_new_tile(nq, nk, d):
    """At the forward's key tile, a skipped last tile and a missing
    accumulator rescale each move O by more than ``parity_atol``."""
    from image_editing_framework_torch.ops import flash_attention as fa

    smoke = _load_script()
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, d).astype(np.float32)).to(torch.bfloat16) for n in (nq, nk, nk))
    ref = fa.flash_attention_reference(q, k, v)
    faults = smoke.fault_readings(q, k, v, ref)
    tol = fa.parity_atol(ref)
    assert nk > smoke.fwd_key_tile(d)
    assert faults["skipped_key_tile"] > tol and faults["no_acc_rescale"] > tol, (faults, tol)


@pytest.mark.parametrize("nq,nk,d", [(200, 300, 64), (130, 200, 160), (300, 260, 40)])
def test_planted_backward_faults_exceed_the_limit_at_the_new_tiles(nq, nk, d):
    """At the backward's tiles (dQ's last key tile, dK/dV's last query
    tile), each planted fault moves every gradient it reaches by more than
    ``grad_parity_atol``: a missing di (dQ and dK), a skipped key tile (dQ),
    a skipped query tile (dK and dV)."""
    from image_editing_framework_torch.ops import flash_attention as fa

    smoke = _load_script()
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, n, d).astype(np.float32)).to(torch.bfloat16)
                   for n in (nq, nk, nk, nq))
    o, lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    ref = fa.flash_attention_bwd_reference(q, k, v, None, o, do, lse)
    tols = {name: fa.grad_parity_atol(r) for name, r in zip(("dq", "dk", "dv"), ref)}
    faults = smoke.bwd_fault_readings(q, k, v, do, o, lse, ref)
    assert nk > smoke.bwd_dq_key_tile(d) and nq > smoke.bwd_dkv_query_tile(d)
    assert set(faults) == {"no_di", "skipped_key_tile_dq", "skipped_query_tile_dkv"}
    for name, reads in faults.items():
        assert reads and all(err > tols[out] for out, err in reads.items()), (name, reads, tols)


@pytest.mark.parametrize("variant,n,d", [("union", 256, 64), ("union", 64, 160), ("mask", 256, 40)])
def test_biased_operands_and_faults(variant, n, d):
    """MasaCtrl's operands as the path builds them (contiguous f32 bias,
    the union plan's segments, the mask's source K/V): the bf16 limit
    rejects a kernel that ignores the bias at the union shapes, a skipped
    key tile and a missing accumulator rescale behind the NEG_INF keys."""
    from image_editing_framework_torch.ops import flash_attention as fa

    smoke = _load_script()
    gen = torch.Generator().manual_seed(0)
    q, k, v, bias = smoke.bias_operands(variant, 4, 2, n, d, gen, device="cpu")
    assert bias.is_contiguous() and bias.dtype == torch.float32 and bias.shape == (4, k.shape[2])
    assert k.shape[2] == (2 * n if variant == "union" else n) and k.shape[2] > smoke.fwd_key_tile(d)
    ref = fa.flash_attention_reference(q, k, v, bias)
    faults = smoke.fault_readings(q, k, v, ref, bias)
    tol = fa.parity_atol(ref)
    must_fail = ["skipped_key_tile", "no_acc_rescale"] + (["bias_ignored"] if variant == "union" else [])
    assert all(faults[name] > tol for name in must_fail), (faults, tol)


@pytest.mark.parametrize("fault", [None, "o_off_by_4_ulp", "lse_off_by_2e-3", "lse_finite_on_a_masked_row"])
def test_hold_forward_rejects_a_wrong_o_or_lse(fault):
    """``hold_forward``, which holds the forward's output and lse at every
    gradient shape in ``phase_bwd_kernels``, passes the plain version's own
    output and rejects an O moved past ``parity_atol``, an lse moved past
    1e-3 on one row, and a finite lse on a row whose every logit is -inf."""
    from image_editing_framework_torch.ops import flash_attention as fa

    smoke = _load_script()
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 200, 64).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(2, 200)
    bias[1] = float("-inf")
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, bias, return_lse=True)
    o, lse = ref_o.clone(), ref_lse.clone()
    if fault == "o_off_by_4_ulp":
        o[0, 0, 7] += 4 * fa.parity_atol(ref_o)
    elif fault == "lse_off_by_2e-3":
        lse[0, 1, 3] += 2e-3
    elif fault == "lse_finite_on_a_masked_row":
        lse[1, 0, 0] = 0.0
    if fault is None:
        err, tol, lse_err = smoke.hold_forward(o, ref_o, lse, ref_lse)
        assert err == 0 and lse_err == 0 and tol > 0
    else:
        with pytest.raises(AssertionError):
            smoke.hold_forward(o, ref_o, lse, ref_lse)


def test_chip_smoke_covers_p2z():
    """pix2pix-zero on the card: the backward kernels are held to their
    plain version at every site at CFG batch 2 (bf16 and f32) and timed
    there; the tiny pipelines' p2z is held to the CPU and its guided steps
    run under the sync check; the path phase reads its launches around
    each part of the run and profiles one guided step."""
    import inspect

    smoke = _load_script()
    assert smoke.P2Z_BATCH == 2 and smoke.SITES == {"sd": 16, "xl": 70, "sd21": 16}
    bwd = inspect.getsource(smoke.phase_bwd_kernels)
    assert "check(dtype, P2Z_BATCH, h, n, n, d" in bwd and "into=p2z_sums" in bwd
    assert "for model, shapes in PATH_SHAPES.items()" in bwd  # every site, the first included
    # the forward's lse instantiation held at every gradient shape, and the
    # plain backward fed the plain forward's o and lse
    assert "hold_forward(o, ref_o, lse, ref_lse)" in bwd
    assert "flash_attention_bwd_reference(q, k, v, bias, ref_o, do, ref_lse)" in bwd
    tiny = inspect.getsource(smoke.phase_tiny)
    assert "tiny_p2z(" in tiny and "p2z_sync_free(gpu" in tiny and "len(edit_errs) != 8" in tiny
    assert 'set_sync_debug_mode("error")' in inspect.getsource(smoke.p2z_sync_free)
    path = inspect.getsource(smoke.phase_p2z_path)
    assert '"ddim", "p2z"' in path and 'cli.run_method("p2z"' in path and "uncond_seq=uncond" in path
    assert "per_step = sites * (2 + int(xl) + int(checkpointed))" in path
    assert "expected = (sites * STEPS + per_step * STEPS, sites * STEPS, sites * STEPS)" in path
    assert 0 <= smoke.P2Z_PROBE_STEP < smoke.STEPS


PROBE_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__d49fe116_12_mma_probe_cu_d868f69216mma_probe_kernelILi1ELi0ELi1ELi40EEEv14CUtensorMap_stS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__d49fe116_12_mma_probe_cu_d868f69216mma_probe_kernelILi1ELi0ELi1ELi40EEEv14CUtensorMap_stS1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, used 2 barriers, 32 bytes smem
ptxas info    : (C7519) warpgroup.arrive is injected in around line 1390 by compiler to allow use of registers in GMMA
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__d49fe116_12_mma_probe_cu_d868f69216mma_probe_kernelILi0ELi1ELi1ELi128EEEv14CUtensorMap_stS1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__d49fe116_12_mma_probe_cu_d868f69216mma_probe_kernelILi0ELi1ELi1ELi128EEEv14CUtensorMap_stS1_NS_6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 2 barriers, 32 bytes smem
ptxas warning : a made-up warning
"""


def test_probe_instances_read_the_ptxas_report():
    """The device phase reads each probe instantiation's plan, major-ness,
    width, registers and spills from the build's report, and its warnings."""
    smoke = _load_script()
    rows, warnings = smoke.probe_instances(PROBE_REPORT)
    assert [{k: r[k] for k in ("kernel", "plan", "ta", "tb", "np", "registers", "spill_stores", "spill_loads")}
            for r in rows] == [
        dict(kernel="mma_probe", plan="pv", ta=0, tb=1, np=40, registers=46, spill_stores=0, spill_loads=0),
        dict(kernel="mma_probe", plan="s", ta=1, tb=1, np=128, registers=128, spill_stores=4, spill_loads=4)]
    assert warnings == ["ptxas warning : a made-up warning"]
    # one instantiation for each S layout and each PV major-ness and wgmma width
    from image_editing_framework_torch.tools import bench_attn_layouts as tprobe

    assert smoke.PROBE_INSTANCES == 2 + 2 * len(tprobe.PV_WIDTHS)


def test_checkpoint_writer_round_trips_through_safetensors(tmp_path):
    """The checkpoint writers' ``save_safetensors`` (the GPU machine has no
    ``safetensors``) writes files that ``safetensors`` reads back: every
    dtype the phase writes, the fp16 cast of floating tensors, integers left
    as they are."""
    from safetensors.numpy import load_file
    from safetensors.torch import load_file as torch_load_file

    from image_editing_framework_torch.models.loader import save_safetensors

    smoke = _load_script()
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "i": torch.arange(6, dtype=torch.int64).reshape(1, 6), "s": torch.tensor(1.5),
               "t": torch.randn(4, 6, generator=g).T, **smoke.clip_position_ids()}
    path = str(tmp_path / "a.safetensors")
    nbytes = save_safetensors(tensors, path)
    got = torch_load_file(path)
    assert nbytes == sum(t.numel() * t.element_size() for t in tensors.values())
    assert set(got) == set(tensors) and all(torch.equal(got[k], v) for k, v in tensors.items())
    path16 = str(tmp_path / "b.safetensors")
    save_safetensors({k: v for k, v in tensors.items() if k != "b"}, path16, torch.float16)
    arrays = load_file(path16)
    np.testing.assert_array_equal(arrays["w"], tensors["w"].to(torch.float16).numpy())
    np.testing.assert_array_equal(arrays["t"], tensors["t"].to(torch.float16).numpy())
    assert arrays["i"].dtype == np.int64 and arrays["text_model.embeddings.position_ids"].shape == (1, 77)


def test_inverse_ldm_rename_gives_back_the_snapshot_keys_at_full_width(monkeypatch):
    """The phase's single file (``to_ldm_single_file``) at SD1.5's full
    width, on meta tensors, through the port's ``convert_single_file``:
    every key and shape of the snapshot's UNet, VAE and text encoder (with
    its ``position_ids``)."""
    from image_editing_framework_torch.models import configs, convert_ldm
    from image_editing_framework_torch.models.clip import CLIP_VIT_L, CLIPTextModel
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.models.vae import AutoencoderKL, VAEConfig
    from image_editing_framework_torch.pipelines import SDPipeline

    smoke = _load_script()
    with torch.device("meta"):
        pipe = SDPipeline("sd", UNet2DCondition(configs.SD15_UNET), AutoencoderKL(VAEConfig()),
                          CLIPTextModel(CLIP_VIT_L), None, None, torch.device("meta"))
    state = smoke.to_ldm_single_file(pipe)
    assert all(k.startswith(("model.diffusion_model.", "first_stage_model.", "cond_stage_model.transformer."))
               for k in state)
    monkeypatch.setattr(convert_ldm, "load_safetensors", lambda path: state)
    unet, vae, text = convert_ldm.convert_single_file("ghostv2.safetensors", configs.SD15_UNET, VAEConfig())
    for got, module, extra in ((unet, pipe.unet, {}), (vae, pipe.vae, {}),
                               (text, pipe.text_encoder, smoke.clip_position_ids())):
        want = dict(module.state_dict(), **extra)
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
        assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)


def test_synthetic_vocab_is_clip_shaped():
    """49408 entries, the special tokens at CLIP's ids, the byte symbols
    first, and merges that make each prompt word one token."""
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer

    smoke = _load_script()
    words = " ".join(smoke.CKPT_PROMPTS).split()
    vocab, merges = smoke.synthetic_clip_vocab(words)
    assert len(vocab) == 49408 and sorted(vocab.values()) == list(range(49408))
    assert (vocab["<|startoftext|>"], vocab["<|endoftext|>"]) == (49406, 49407)
    assert len(set(merges)) == len(merges)
    tok = CLIPTokenizer(vocab, merges)
    for prompt in smoke.CKPT_PROMPTS:
        assert tok.encode(prompt) == [49406] + [vocab[w + "</w>"] for w in prompt.split()] + [49407]
    assert {"cat</w>", "dog</w>"} <= set(vocab)


def test_mini_pie_writer(tmp_path):
    """The sweep phase's mini PIE at a small size: three items in the
    default categories (one P2P replace pair, two refine), the category-5
    item outside them, brackets stripped, JPEGs at the asked size that are
    not flat, and every prompt word one token of the checkpoints' vocab."""
    from PIL import Image

    from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE
    from image_editing_framework_torch.eval.sweep import _auto_p2p_config
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer
    from image_editing_framework_torch.utils.images import load_image

    smoke = _load_script()
    root = smoke.write_mini_pie(str(tmp_path / "PIE"), 48)
    work = [it for c in DEFAULT_CATEGORIES for it in PIE(root, c).items]
    assert len(work) == 3 and len(PIE(root)) == 4 and len(PIE(root, 5)) == 1
    assert sorted(_auto_p2p_config(it.source_prompt, it.target_prompt).edit_type for it in work) == \
        ["refine", "refine", "replace"]
    vocab, merges = smoke.synthetic_clip_vocab(smoke.CKPT_WORDS)
    tok = CLIPTokenizer(vocab, merges)
    for it in PIE(root).items:
        with Image.open(it.image_path) as im:
            assert im.format == "JPEG" and im.size == (48, 48)
        img = load_image(it.image_path, 48, 48)
        assert img.shape == (48, 48, 3) and img.std() > 5
        for prompt in (it.source_prompt, it.target_prompt):
            assert "[" not in prompt
            assert tok.encode(prompt) == [49406] + [vocab[w + "</w>"] for w in prompt.split()] + [49407]


def test_sweep_launch_arithmetic():
    """The sweep phase's exact launch counts: per SD1.5 512² image 50 DDIM
    inversion forwards and 50 edit forwards at 16 sites (800 each from the
    cache), three images; the SDXL ``edit_real`` 2 x 50 forwards at 70."""
    smoke = _load_script()
    assert smoke.sweep_launches(smoke.SITES["sd"], 3, smoke.STEPS, cached=False) == 4800
    assert smoke.sweep_launches(smoke.SITES["sd"], 3, smoke.STEPS, cached=True) == 2400
    assert smoke.sweep_launches(smoke.SITES["sd"], 1, smoke.STEPS, cached=False) == 1600
    assert smoke.SITES["xl"] * 2 * smoke.STEPS == 7000
    assert smoke.SWEEP_STATS_KEYS < smoke.SWEEP_DONE_KEYS


def test_xl_checkpoint_writers_round_trip_on_the_cpu(tmp_path):
    """The SDXL phase's writers at the tiny SDXL size: the snapshot, the
    LDM single file (bigG through ``to_open_clip``) and the refiner's UNet
    load through the port's ``load_pipeline(..., device="cpu")`` as
    "xl-base", "animagineXL" and "xl-refiner", every tensor equal to the
    written module's through fp16; the refiner shares the base's VAE, bigG
    tower and tokenizer."""
    import dataclasses

    from image_editing_framework_torch.models import configs, registry
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.pipelines import _build, tiny_pipeline

    smoke = _load_script()
    pipe = tiny_pipeline(num_steps=4, model_type="xl", device="cpu")
    refiner_cfg = dataclasses.replace(configs.TINY_REFINER_UNET, cross_attention_dim=16)
    refiner_unet = _build(UNet2DCondition, refiner_cfg, torch.device("cpu"), torch.float32, 5)
    written = smoke.write_xl_checkpoints(pipe, refiner_unet, str(tmp_path), smoke.CKPT_WORDS)
    assert set(written) == {"snapshot", "single_file", "refiner"}
    spec = registry.VersionSpec("xl", pipe.unet.config, pipe.text_encoder.config, pipe.text_encoder_2.config,
                                vae=pipe.vae.config)
    refiner_spec = registry.VersionSpec("xl", refiner_cfg, pipe.text_encoder_2.config, vae=pipe.vae.config)

    def through_fp16(module, got):
        want = module.state_dict()
        assert set(got.state_dict()) == set(want)
        for k, v in got.state_dict().items():
            assert torch.equal(v, want[k].to(torch.float16).to(torch.float32)), k

    for version, path in (("xl-base", written["snapshot"][0]), ("animagineXL", written["single_file"][0])):
        loaded = registry.load_pipeline(version, 4, path=path, spec=spec, device="cpu")
        for name in ("unet", "vae", "text_encoder", "text_encoder_2"):
            through_fp16(getattr(pipe, name), getattr(loaded, name))
        assert loaded.tokenizer.encode("a white cat") == loaded.tokenizer_2.encode("a white cat")
    both = registry.load_pipeline("xl-refiner", 4, path=written["snapshot"][0], spec=spec,
                                  refiner_path=written["refiner"][0], refiner_spec=refiner_spec, device="cpu")
    through_fp16(refiner_unet, both.refiner.unet)
    assert both.refiner.vae is both.vae and both.refiner.text_encoder_2 is both.text_encoder_2
    assert both.refiner.tokenizer_2 is both.tokenizer_2 and both.refiner.is_refiner
    assert written["refiner"][1] == sum(t.numel() * 2 for t in refiner_unet.state_dict().values())


def test_batched_launch_arithmetic():
    """A group launches what one image of its method launches: the service's
    P2P group of 4 and MasaCtrl group of 2 each 50 inversion and 50 edit
    forwards at 16 sites, the synthesis request 50 edit forwards, the bad
    method none; the batched sweep's group of 3 as one image. The kernels
    phases hold the groups' batches: the forward at each group's G and
    CFG-4 x G, NTI's 3 and p2z's CFG-2 x 2 backward."""
    smoke = _load_script()
    sites = smoke.SITES["sd"]
    assert smoke.sweep_launches(sites, 1, smoke.STEPS, cached=False) == 1600  # a group, or the sweep's group of 3
    assert smoke.sweep_launches(sites, 1, smoke.STEPS, cached=True) == 800  # a synthesis inverts nothing
    assert len(smoke.P2P_GROUP) == smoke.SERVE_GROUP == 4 and len(smoke.MASA_GROUP) == 2
    assert set(smoke.P2P_GROUP) | set(smoke.MASA_GROUP) | {"syn", "nope"} == set(smoke.SERVE_SPOOL)
    assert (4 * smoke.SERVE_GROUP, smoke.NTI_GROUP, smoke.P2Z_BATCH * smoke.P2Z_GROUP) == (16, 3, 4)
    assert smoke.SWEEP_GROUP == 3 and smoke.group_batches() == [2, 3, 8, 12, 16]


def test_serve_spool_groups_and_words():
    """The service's P2P group mixes two replace and two refine pairs (the
    word-count rule the service applies), and every prompt word is a whole
    token of the snapshot's synthetic vocab."""
    from image_editing_framework_torch.eval.sweep import _auto_p2p_config

    smoke = _load_script()
    kinds = [_auto_p2p_config(*smoke.SERVE_SPOOL[n][1:3]).edit_type for n in smoke.P2P_GROUP]
    assert sorted(kinds) == ["refine", "refine", "replace", "replace"]
    words = {w for method, s, t, _ in smoke.SERVE_SPOOL.values() if method != "nope" for w in (s + " " + t).split()}
    assert words <= set(smoke.CKPT_WORDS)
    assert [smoke.SERVE_SPOOL[n][3] for n in smoke.P2P_GROUP + smoke.MASA_GROUP] == [True] * 6
    assert not smoke.SERVE_SPOOL["syn"][3]


def test_chip_smoke_wires_the_serving_path():
    """main() runs the serve phase on the SD1.5 snapshot after the sweep
    and before the NTI path, and the kernels line counts its launches and
    the batched sweep run's; the tiny phase holds the batched editors."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    assert source.index("phase_sweep_path") < source.index("phase_serve_path") < source.index("phase_nti_path")
    assert '"serve_path": launches["serve"]' in source and '"sweep_batched_run": sweep_runs["d"]' in source
    assert "tiny_batched" in inspect.getsource(smoke.phase_tiny)
    assert '"--batch_size", str(SWEEP_GROUP)' in inspect.getsource(smoke.phase_sweep_path)


def test_tiny_batched_rehearses_on_the_cpu():
    """The tiny phase's batched check on the CPU: every case runs, the group
    agrees with each image alone within the phase's 1e-3, and the batched
    NTI's images stop at different inner iterations."""
    from image_editing_framework_torch.pipelines import tiny_pipeline

    smoke = _load_script()
    out, seqs, stops = smoke.tiny_batched(tiny_pipeline(num_steps=4, device="cpu"), "sd")
    assert len(out) + len(seqs) == 9 and stops[0] == smoke.TINY_NTI_STOPS
    for name, (group, alone) in list(out.items()) + list(seqs.items()):
        assert (group - alone).abs().max().item() < 1e-3, name


def test_validation_launch_arithmetic():
    """The validation phase's exact launch counts at SD1.5 512², 50 steps:
    the four methods' synthesized edits (P2P, MasaCtrl and PnP 50 forwards
    each, p2z 150 and 50 backwards), one DDIM inversion shared by the four
    real-image edits, and those edits again: 10 400 forward and 1 600 of
    each backward; the P2P rerun 2 400 forward."""
    from image_editing_framework_torch.eval.validate import METHODS

    smoke = _load_script()
    sites, steps = smoke.SITES["sd"], smoke.STEPS
    assert smoke.validation_launches(sites, steps, METHODS, real=True) == (10400, 1600, 1600)
    assert smoke.validation_launches(sites, steps, ("p2p",), real=True) == (2400, 0, 0)
    assert smoke.validation_launches(sites, steps, METHODS, real=False) == (4800, 800, 800)
    assert set(smoke.VALIDATION_FORWARDS) == set(smoke.VALIDATION_BACKWARDS) == set(METHODS)


def test_chip_smoke_wires_the_validation_path():
    """main() runs the validation phase on the SD1.5 snapshot after the
    serve phase and before the NTI path, and the kernels line counts its
    launches (the forward's and both backwards'); the loaded refiner's
    img2img goes through the runway's ``validate_refiner``; the runway's
    prompts are whole tokens of the snapshot's synthetic vocab."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    assert source.index("phase_serve_path") < source.index("phase_validation_path") < source.index("phase_nti_path")
    assert '"validation_path": launches["validation"]' in source
    assert '"validation_rerun": launches["validation_rerun"]' in source
    assert '"validation_path": validation[0][i + 1]' in source
    assert "validate_refiner(" in inspect.getsource(smoke.phase_xl_checkpoint_path)
    phase = inspect.getsource(smoke.phase_validation_path)
    assert "validate.main(" in phase and "golden_check.main(" in phase and '"--method", "p2p"' in phase
    assert "TOWER_RTOL" in phase
    assert set(" ".join(smoke.CKPT_PROMPTS).split()) <= set(smoke.CKPT_WORDS)
    assert smoke.TOWER_RTOL == 1e-4


def test_clip_checkpoint_writer_gives_clip_scores_shapes(tmp_path, monkeypatch):
    """The phase's random CLIP checkpoint loads into ``CLIPScore`` (here at
    a tiny width patched into ``models/clip.py``, as the scorer and the
    writer both read it there) and scores in [0, 100]."""
    import dataclasses
    import functools

    from image_editing_framework_torch.eval.metrics import CLIPScore
    from image_editing_framework_torch.models import clip

    monkeypatch.setattr(clip, "CLIP_VIT_B32_VISION", dataclasses.replace(clip.TINY_CLIP_VISION, image_size=224,
                                                                         patch_size=32))
    monkeypatch.setattr(clip, "CLIPTextConfig", functools.partial(clip.CLIPTextConfig, vocab_size=1024,
                                                                  hidden_size=32, num_layers=2, num_heads=2,
                                                                  intermediate_size=64))
    smoke = _load_script()
    nbytes = smoke.write_clip_checkpoint(str(tmp_path), smoke.CKPT_WORDS, "cpu")
    scorer = CLIPScore(str(tmp_path), device="cpu")
    assert nbytes == 2 * sum(p.numel() for m in (scorer.text, scorer.vision) for p in m.parameters()) + 8 * 77
    img = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    assert 0.0 <= scorer(img, [smoke.CKPT_PROMPTS[1]]) <= 100.0
    ids = scorer.tokenizer.encode(smoke.CKPT_PROMPTS[1])
    assert len(ids) == len(smoke.CKPT_PROMPTS[1].split()) + 2  # every word one token


def test_xl_p2z_nti_cut_keeps_steps_and_embeddings_aligned():
    """The p2z edits on the DDIM inversion run every
    ``XL_P2Z_NTI_STRIDE``-th step of the 50: that schedule's k-th timestep
    is the full schedule's step stride * k + stride - 1, and its first
    latent is the 50-step inversion trajectory's entry at that timestep.
    The edits on NTI embeddings take the same steps of a 50-step NTI run
    (SD1.5's: ``strided_nti``, its trajectory's entry and its embeddings at
    those steps) and an NTI run's own cut steps (SDXL's NTI path runs every
    ``XL_NTI_STRIDE``-th step), its last latent and all its embeddings, as
    the MasaCtrl edit on them does."""
    import inspect

    from image_editing_framework_torch.core.scheduler import inversion_timestep, make_ddim_schedule

    smoke = _load_script()
    stride, steps = smoke.XL_P2Z_NTI_STRIDE, smoke.STEPS
    assert steps % stride == 0 and stride > 1
    full, short = make_ddim_schedule(steps), make_ddim_schedule(steps // stride)
    assert [int(t) for t in short.timesteps] == [int(full.timesteps[stride * k + stride - 1])
                                                 for k in range(steps // stride)]
    # trajectory entry j + 1 is the latent after inversion step j, at inversion_timestep(full, j)
    j = steps + 1 - stride - 1
    assert inversion_timestep(full, j) == int(short.timesteps[0])
    path = inspect.getsource(smoke.phase_p2z_path)
    assert "ddim_traj[STEPS + 1 - stride], None, STEPS // stride" in path
    assert '("nti", *strided_nti(nti, stride))' in path
    assert "pipe.scheduler = denoise, guided, full_schedule" in path  # the full schedule restored
    assert steps % smoke.XL_NTI_STRIDE == 0 and smoke.XL_NTI_STRIDE > 1
    nti = inspect.getsource(smoke.phase_nti_path)
    assert "steps = STEPS if model == \"sd\" else STEPS // XL_NTI_STRIDE" in nti
    assert "sites * 4 * steps + per_iteration * j" in nti and "pipe.scheduler = inner, config_for, full_schedule" in nti
    masa = inspect.getsource(smoke.phase_masactrl_path)
    assert '("nti_mutual", nti[0], dict(uncond_seq=nti[1]), sites, nti[1].shape[0])' in masa
    # strided_nti: a 50-step run's embeddings at the short schedule's steps and its trajectory's entry at
    # the short schedule's first timestep; a run already cut gives its own
    seq, traj, last = torch.arange(steps), torch.arange(steps + 1), torch.tensor(-1)
    start, embeddings, n = smoke.strided_nti((last, seq, traj), stride)
    assert n == steps // stride and embeddings.tolist() == [stride * k + stride - 1 for k in range(n)]
    assert int(start) == steps + 1 - stride and inversion_timestep(full, int(start) - 1) == int(short.timesteps[0])
    cut = torch.arange(steps // stride)
    assert smoke.strided_nti((last, cut, traj), stride) == (last, cut, steps // stride)


def test_chip_smoke_wires_the_cp_path():
    """cp_path runs after the refiner, its launches join the kernels line
    (the main path under the ring for the forward, the ring's backward for
    both backward kernels), its shapes are SDXL's and SD1.5's 4096-token
    sites, and SDXL's UNet under the ring on n ranks launches 60 + 10 n
    kernels a forward; SDXL's p2z DDIM run takes the NTI run's stride."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    assert source.index("phase_refiner") < source.index("phase_cp_path") < source.index('emit("seconds"')
    assert '"cp_path": launches["cp"]' in source and '"cp_path": cp_bwd[i]' in source
    assert smoke.CP_SITES == {"xl": (4, 10, 4096, 64), "sd": (4, 8, 4096, 40)}
    n, d, h, sites = smoke.PATH_SHAPES["xl"][0]
    assert (n, d, h, sites) == (smoke.CP_MIN_SEQ, 64, 10, smoke.CP_BIG_SITES)
    assert [smoke.SITES["xl"] - smoke.CP_BIG_SITES + smoke.CP_BIG_SITES * n for n in (2, 4)] == [80, 100]
    assert smoke.CP_UNET_CONFIG == "SDXL_UNET" and smoke.CP_GRAD_BATCHES == (1, 2)
    checks = inspect.getsource(smoke.cp_kernel_checks)
    for fault in ("no_home_rotation", "local_lse"):
        assert fault in checks
    assert "per_forward * STEPS" in inspect.getsource(smoke.cp_main_path)
    path = inspect.getsource(smoke.phase_p2z_path)
    assert '"ddim", last if stride == 1 else ddim_traj[STEPS + 1 - stride], None, STEPS // stride' in path


@pytest.mark.parametrize("home,global_lse", [(True, True), (False, True), (True, False)])
def test_ring_backward_variants_on_one_rank(tmp_path, home, global_lse):
    """On a group of one rank the ring is the flash function itself: the
    sound variant of chip_smoke's ring backward gives its gradients, the
    planted faults change nothing there (they need a second rank to bite,
    which cp_path and tests/test_torch_ring_attention.py have)."""
    import datetime

    import torch.distributed as dist

    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.parallel import ring_attention as ra

    smoke = _load_script()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        group = dist.group.WORLD
        gen = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(1, 2, 32, 16, generator=gen) for _ in range(4))
        o, lse = ra._ring_forward(q, k, v, None, group, 0.25)
        ref = fa.flash_attention_bwd_reference(q, k, v, None, o, do, lse, 0.25)
        got = smoke.cp_ring_backward_variant(q, k, v, o, do, lse, group, 0.25, home=home, global_lse=global_lse)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    finally:
        dist.destroy_process_group()


def test_chip_smoke_wires_the_tp_part():
    """Part (d) runs in cp_path's group of 2 on a data 1 x tensor 2 mesh,
    its first check on (b)'s SDXL module; the ranks' results are held to
    each other and its launches join the kernels line under ``tp_path``;
    the profiler check runs in the SD1.5 profile phase and the pipeline
    cache in the checkpoint phase."""
    import inspect

    smoke = _load_script()
    rank = inspect.getsource(smoke.cp_rank)
    assert 'make_mesh(data=1, tensor=2, device_type="cuda")' in rank and "tp_parts(tp_mesh, device)" in rank
    assert "tp_unet_forward(unet, tp_mesh, lat, 501, ctx, added, ref)" in inspect.getsource(smoke.cp_unet_forward)
    assert "tp_line(two)" in inspect.getsource(smoke.phase_cp_path)
    main = inspect.getsource(smoke.main)
    assert main.count('"tp_path": tp_launches') == 2 and "tp_launches[i + 1]" in main
    assert "profiling_check(" in inspect.getsource(smoke.phase_profile)
    assert "pipeline_cache_round_trip(loaded" in inspect.getsource(smoke.phase_checkpoint_path)
    assert (smoke.TP_RTOL, smoke.TP_ENCODE_RTOL, smoke.TP_TRAIN_BATCH, smoke.TP_GRAD_FLOOR) == (1e-3, 1e-4, 2, 1e-3)
    assert smoke.TP_GRAD_FAULTS == ("copy", "dkv") and "tp_planted(fault)" in inspect.getsource(smoke.tp_train_step)


def test_tp_part_rehearses_on_cpu_ranks(tmp_path):
    """chip_smoke.py's tensor-parallel checks on two CPU ranks at tiny
    size, (d4) NTI and (d5) pix2pix-zero included: they pass (the train
    step's gate rejecting its two planted gradient faults on the way), the
    two ranks' results agree bitwise (NTI's stops too), and with GEGLU's
    halves split together, or with the column-parallel layers' input
    gradients left unreduced throughout, a check fails."""
    from torch_cp_workers import launch

    ranks = launch("tp_smoke", 2, tmp_path)
    for res in ranks:
        assert str(res["sound/error"]) == "", str(res["sound/error"])
        assert np.all(res["sound/errors"] >= 0)
        assert str(res["geglu_fault/error"]).startswith("tp "), str(res["geglu_fault/error"])
        # the column-parallel input gradients left unreduced: the p2z guided step's gradient, the first
        # check that differentiates through the split UNet, rejects them
        assert str(res["copy_fault/error"]).startswith("tp p2z guided step gradient"), str(res["copy_fault/error"])
    for key in (k for k in ranks[0] if k.startswith("sound/") and k != "sound/errors"):
        assert str(ranks[0][key]) == str(ranks[1][key]), key
    for key in ("p2z_step/digest", "nti/digest", "nti/stops", "p2z/digest"):
        assert f"sound/{key}" in ranks[0], key


def test_chip_smoke_wires_the_sd21_path():
    """sd21_path runs after the SDXL paths and before the refiner, its NTI
    run after it on its loaded pipe; both join the kernels line (the forward's
    launches, both backwards' from the NTI run) and the share lines; SD2.1's
    shapes are its 768² sites at head dim 64 (the sums of its UNet
    forward's 16 and its gradient's 15); the conversion goes through the
    port's tool; cp_main_path runs on the 10-step schedule."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    assert source.index('("sd", ""), ("xl", "xl_")') < source.index("phase_sd21_path") < source.index(
        '"sd21_nti_path", phase_nti_path, "sd21"') < source.index("phase_refiner")
    assert '"sd21_path": launches["sd21"]' in source and '"sd21_nti_path": bwd_launches["sd21"][i]' in source
    assert '"at_sd21"' in source and 'emit("share", model="sd21"' in source
    assert smoke.PATH_SHAPES["sd21"] == [(9216, 64, 5, 5), (2304, 64, 10, 5), (576, 64, 20, 5), (144, 64, 20, 1)]
    assert [shape[:3] for shape in smoke.GRAD_SHAPES["sd21"]] == [shape[:3] for shape in smoke.PATH_SHAPES["sd21"]]
    assert [n for n, *_ in smoke.PATH_SHAPES["sd21"]] == [(768 // 8 // 2**level) ** 2 for level in range(4)]
    assert all(d == 64 and h * d in (320, 640, 1280) for _, d, h, _ in smoke.PATH_SHAPES["sd21"])
    assert smoke.FAMILIES["sd21"] == ("2.1", "SD2.1", 768, 1024) and set(smoke.MODELS) == {"sd", "xl"}
    phase = inspect.getsource(smoke.phase_sd21_path)
    assert "tools.convert_checkpoint" in phase and '"--family", "sd21"' in phase and "cli.load_pipe(version)" in phase
    assert "cli.invert(" in phase and 'cli.run_method("p2p"' in phase
    main_path = inspect.getsource(smoke.cp_main_path)
    assert "num_steps=steps" in main_path and "steps = STEPS // XL_NTI_STRIDE" in main_path


@pytest.mark.parametrize("n,d", [(576, 64), (144, 64)])
def test_planted_faults_exceed_the_limit_at_sd21s_ragged_sites(n, d):
    """At SD2.1's 576- and 144-token sites, whose last key tile is part
    filled, a skipped last tile and a missing rescale each move O by more
    than the bf16 limit, as head-split views (the card runs the same
    readings on the kernel's output)."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads

    smoke = _load_script()
    gen = torch.Generator().manual_seed(0)
    q, k, v = (split_heads(torch.randn(1, n, 4 * d, generator=gen).to(torch.bfloat16), 4) for _ in range(3))
    ref = fa.flash_attention_reference(q, k, v)
    faults = smoke.fault_readings(q, k, v, ref)
    tol = fa.parity_atol(ref)
    assert faults["skipped_key_tile"] > tol and faults["no_acc_rescale"] > tol, (faults, tol)


def test_sd21_single_file_writer_round_trips_on_meta(monkeypatch):
    """The SD2.1 phase's single file (``to_ldm_single_file_21``) at full
    width, on meta tensors, through the port's ``convert_single_file``:
    every key and shape of the UNet, VAE and OpenCLIP-H tower, and the 24th
    resblock kept beside the 23 the tower has (the loader ignores it)."""
    from image_editing_framework_torch.models import configs, convert_ldm
    from image_editing_framework_torch.models.vae import VAEConfig
    from image_editing_framework_torch.pipelines import random_pipeline

    smoke = _load_script()
    pipe = random_pipeline("2.1", num_steps=2, device="meta")
    state = smoke.to_ldm_single_file_21(pipe)
    assert all(k.startswith(("model.diffusion_model.", "first_stage_model.", "cond_stage_model.model."))
               for k in state)
    assert "cond_stage_model.model.transformer.resblocks.23.attn.in_proj_weight" in state
    monkeypatch.setattr(convert_ldm, "load_safetensors", lambda path: state)
    unet, vae, text = convert_ldm.convert_single_file("sd21.safetensors", configs.SD21_UNET, VAEConfig())
    for got, module in ((unet, pipe.unet), (vae, pipe.vae), (text, pipe.text_encoder)):
        want = module.state_dict()
        extra = sorted(set(got) - set(want))
        assert set(want) <= set(got) and all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
        assert extra == ([] if module is not pipe.text_encoder else
                         sorted(k.replace("layers.22.", "layers.23.") for k in want if ".layers.22." in k))


def test_grad_launch_arithmetic():
    """The gradient paths' exact launch counts: one image's p2z at 10 steps
    (SD1.5: 480 + 160 for its inversion and 160 of each backward; SDXL's
    defaults: references recomputed, the checkpointed UNet, 3500 and 700,
    as ``xl_p2z_path``'s run); NTI (SD1.5 at J = 100 over 50 steps: 3200,
    1500, as ``nti_path``'s NTI call; the service's null-text group of 2
    one by one);
    and under the ring at SDXL on 2 ranks: 80 forward launches a UNet
    forward, NTI's backward at 78 (the first site, a ring site, takes no
    gradient), p2z's at 80."""
    smoke = _load_script()
    sd, xl, grad = smoke.SITES["sd"], smoke.SITES["xl"], smoke.GRAD_SITES["sd"]
    assert smoke.p2z_launches(sd, 10) == (640, 160, 160)
    assert smoke.p2z_launches(sd, 50, inverted=False) == (2400, 800, 800)
    assert smoke.p2z_launches(xl, 10, recompute=True, checkpointed=True, inverted=False) == (3500, 700, 700)
    assert smoke.nti_launches(sd, grad, 50, 100) == (3200, 1500, 1500)
    assert smoke.nti_launches(xl, smoke.GRAD_SITES["xl"], 10, 10, checkpointed=True) == (2800, 690, 690)
    assert smoke.nti_launches(sd, grad, 10, 40, images=2) == (16 * 80, 600, 600)
    world, per_forward = 2, xl + smoke.CP_BIG_SITES
    assert per_forward == 80 and smoke.SITES["xl"] - smoke.GRAD_SITES["xl"] == 1
    assert smoke.nti_launches(per_forward, per_forward - world, 5, 7, checkpointed=True) == (80 * 24, 78 * 7, 78 * 7)
    assert smoke.p2z_launches(per_forward, 10, recompute=True, checkpointed=True, inverted=False,
                              grad_sites=per_forward) == (4000, 800, 800)
    # the backward kernels are held at every batch the new paths give them, with planted faults
    source = inspect.getsource(smoke.phase_bwd_kernels)
    assert '(P2Z_BATCH * P2Z_GROUP, "xl", PATH_SHAPES["xl"])' in source and "faults=True" in source
    assert smoke.P2Z_BATCH * smoke.P2Z_GROUP == 4 and smoke.NTI_GROUP == 3


def test_grad_spool_groups_and_words():
    """The service's gradient spool makes two groups of 2, a pix2pix-zero
    DDIM group and a P2P null-text group, by the service's own grouping
    key; every prompt word is a whole token of the snapshot's synthetic
    vocab; batched NTI's three pairs and SDXL's p2z group have their
    sizes."""
    from image_editing_framework_torch.pipelines import tiny_pipeline
    from image_editing_framework_torch.serve import EditService

    smoke = _load_script()
    svc = EditService(tiny_pipeline(num_steps=4, device="cpu"), os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                                                             "ief_grad_spool_keys"), max_batch=2)
    keys = {name: svc._batch_key(dict(method=m, source_prompt=s, target_prompt=t, image_path="x.png",
                                      inversion_type=inv))
            for name, (m, s, t, inv) in smoke.GRAD_SPOOL.items()}
    assert {keys[n] for n in smoke.P2Z_SERVE_GROUP} == {("p2z", True, "ddim")}
    assert {keys[n] for n in smoke.NTI_SERVE_GROUP} == {("p2p", True, "null-text")}
    assert set(smoke.P2Z_SERVE_GROUP) | set(smoke.NTI_SERVE_GROUP) == set(smoke.GRAD_SPOOL)
    assert len(smoke.P2Z_SERVE_GROUP) == len(smoke.NTI_SERVE_GROUP) == smoke.P2Z_GROUP == 2
    words = {w for _, s, t, _ in smoke.GRAD_SPOOL.values() for w in (s + " " + t).split()}
    words |= {w for pair in smoke.NTI_GROUP_PAIRS for p in pair for w in p.split()}
    assert words <= set(smoke.CKPT_WORDS)
    assert len(smoke.NTI_GROUP_PAIRS) == smoke.NTI_GROUP == len(smoke.TINY_NTI_SCALES)
    assert len(smoke.XL_P2Z_PAIRS) == smoke.P2Z_GROUP
    svc._io_pool.shutdown()
    svc._finalize_pool.shutdown()


def test_launcher_shards_partition_the_mini_pie(tmp_path):
    """The launcher phase's gate: the mini PIE's default-category items,
    strided over LAUNCHER_SHARDS as ``run_sweep`` strides them, partition
    the items; the category-5 item is in no shard."""
    from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE

    smoke = _load_script()
    pie = smoke.write_mini_pie(str(tmp_path / "PIE"), 16)
    work = [it.key for c in DEFAULT_CATEGORIES for it in PIE(pie, c).items]
    shards = [work[i::smoke.LAUNCHER_SHARDS] for i in range(smoke.LAUNCHER_SHARDS)]
    assert sorted(k for shard in shards for k in shard) == sorted(work) and len(work) == 3
    assert all(shards) and not set(shards[0]) & set(shards[1])
    assert len(PIE(pie).items) == len(work) + 1
    launcher = inspect.getsource(smoke.phase_launcher_path)
    for flag in ("--random_weights", "--num_steps", "--shard_index", "--shard_count", "--exp_path"):
        assert f'"{flag}"' in launcher, flag
    assert '"--num_processes"' not in launcher  # its process group takes NCCL, which refuses two ranks on one card


def test_frozen_after_stop_reads_the_recorded_embeddings():
    """``frozen_after_stop`` counts the entries where an image that has
    stopped enters a later inner iteration with the step's result, and
    fails where one moved, or where the recorded iterations and the stops
    disagree."""
    smoke = _load_script()
    g, steps = 3, 2
    seqs = torch.randn(g, steps, 4, 5)
    stops = [[2, 1, 2], [1, 1, 2]]
    embeddings = []
    for i, step in enumerate(stops):
        for j in range(max(step)):
            u = torch.randn(g, 4, 5)
            for k, stop in enumerate(step):
                if j >= stop:
                    u[k] = seqs[k, i]
            embeddings.append(u)
    assert smoke.frozen_after_stop(stops, embeddings, seqs) == 3
    moved = [u.clone() for u in embeddings]
    moved[1][1] += 1e-7
    with pytest.raises(AssertionError, match="image 1 stopped after 1"):
        smoke.frozen_after_stop(stops, moved, seqs)
    with pytest.raises(AssertionError, match="recorded"):
        smoke.frozen_after_stop(stops, embeddings[:-1], seqs)


def test_step0_epsilon_splits_a_tiny_group():
    """``step0_epsilon`` on the tiny pipeline's group of 3 (its start
    latents scaled by TINY_NTI_SCALES): batched NTI at that epsilon stops
    the images at step 0 after 1 and after 2 inner iterations, and the
    recorded embeddings show the stopped ones frozen."""
    from image_editing_framework_torch.core.config import NTIConfig
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.pipelines import tiny_pipeline

    smoke = _load_script()
    pipe = tiny_pipeline(num_steps=4, device="cpu")
    prompts = [p[0] for p in smoke.NTI_GROUP_PAIRS]
    scales = torch.tensor(smoke.TINY_NTI_SCALES)[:, None, None, None, None]
    lats = torch.from_numpy(np.random.RandomState(2).randn(3, 1, 16, 16, 4).astype(np.float32)) * scales
    _, trajs = batched.ddim_invert_batch(pipe, lats, prompts, return_trajectory=True)
    epsilon, losses = smoke.step0_epsilon(pipe, trajs, prompts)
    assert min(losses) < epsilon < max(losses)
    with smoke.nti_recorded() as seen:
        seqs, stops = batched.nti_batch(pipe, trajs, prompts, NTIConfig(num_inner_steps=2, epsilon=epsilon),
                                        return_stops=True)
    assert sorted(set(stops[0])) == [1, 2]
    assert smoke.frozen_after_stop(stops, seen["embeddings"], seqs) >= 1
    assert len(seen["losses"]) == sum(max(step) for step in stops)


def test_trajectory_at_takes_the_coarse_schedules_entries():
    """(e2)'s trajectory: of a 10-step inversion trajectory, the clean latent
    and the entries at the 5-step schedule's inversion timesteps."""
    from image_editing_framework_torch.core.scheduler import inversion_timestep, make_ddim_schedule

    smoke = _load_script()
    full, short = make_ddim_schedule(10), make_ddim_schedule(smoke.CP_NTI_STEPS)
    traj = torch.arange(11)
    got = smoke.trajectory_at(traj, full, short).tolist()
    assert got == [0, 1, 3, 5, 7, 9]
    assert [inversion_timestep(full, j - 1) for j in got[1:]] == [inversion_timestep(short, m) for m in range(5)]


def test_chip_smoke_wires_the_gradient_paths():
    """main() runs grad_groups_path and the launcher on the SD1.5 snapshot
    after the service, xl_p2z_group_path on the XL pipe after xl_p2z_path,
    and cp_path's part (e) in its group of 2; the kernels line counts
    their launches by path; the runway and the p2z edits take their cuts."""
    smoke = _load_script()
    main = inspect.getsource(smoke.main)
    assert main.index("phase_serve_path") < main.index("phase_grad_groups_path") < main.index(
        "phase_launcher_path") < main.index("phase_validation_path")
    assert main.index("phase_p2z_path") < main.index("phase_xl_p2z_group_path") < main.index("del profile_args")
    for key in ("grad_groups_path", "xl_p2z_group_path", "cp_grad_path"):
        assert main.count(f'"{key}": ') == 2, key
    rank = inspect.getsource(smoke.cp_rank)
    assert 'parts="abcde"' in rank and "ring_grad_paths(" in rank and 'grads="e" in parts' in rank
    assert "cp_unet_gradients(unet, mesh, lat, ctx, added)" in inspect.getsource(smoke.cp_unet_forward)
    assert "cp_grad_line(two)" in inspect.getsource(smoke.phase_cp_path)
    parts = inspect.getsource(smoke.tp_parts)
    assert parts.index("tp_p2z_step(pipe, latent_side)") < parts.index("tp_control_forward") < parts.index(
        "tp_grad_paths(pipe, side)") < parts.index("tp_train_step")
    assert smoke.VALIDATION_STEPS == 10 and '"--num_steps", str(VALIDATION_STEPS)' in inspect.getsource(
        smoke.phase_validation_path)
    assert (smoke.GRAD_STRIDE, smoke.GRAD_INNER_STEPS, smoke.GRAD_RTOL, smoke.CP_NTI_STEPS) == (5, 2, 1e-3, 5)


def test_ring_grad_paths_rehearse_on_cpu_ranks(tmp_path):
    """chip_smoke.py's part (e) on two CPU ranks at tiny size: the f32
    gradients through the checkpointed UNet under the ring within their
    limit of the unsharded ones, NTI and pix2pix-zero under the ring with
    the checkpointed UNet (its recomputation reruns the ring's collectives
    in the backward pass); the two ranks' gradients, embeddings, stops and
    images bitwise equal."""
    from torch_cp_workers import launch

    ranks = launch("cp_smoke", 2, tmp_path)
    for res in ranks:
        for batch in ("batch1", "batch2"):
            assert np.all(res[f"{batch}/errors"] <= res[f"{batch}/limits"]), batch
        assert res["checkpointed"].tolist() == [True, True]
        assert len(res["nti/stops"]) == _load_script().CP_NTI_STEPS and np.all(np.isfinite(res["nti/losses"]))
    for key in ranks[0]:
        if not key.endswith("errors") and key != "rank":
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
