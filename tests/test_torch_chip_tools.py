"""The GPU scripts' CPU-side pieces: ``chip_ab.py`` imports nothing of JAX,
takes the five redesigned kernels, refuses to run without a card, scales its
differences without the -1e30 sentinel, tells the scratch-less forward
source apart and times the step kernels at R = 256, 2,048, 4,096 and the host
loop's step; ``chip_smoke.launch_split`` splits a kernel's profiled launches by their
position within one call, ``chip_smoke.hmma_counts`` counts each product kernel
without a tensor-core instruction (on a stand-in ``cuobjdump``), and
``chip_smoke.bound`` holds an f32 step kernel's operations at three tf32
passes at the tensor cores' peak."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_ab  # noqa: E402
import chip_smoke  # noqa: E402


def test_chip_ab_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_ab.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "optax", "flax")
           or n.split(".")[0] == "uav_bs_ctrl_tpu"]
    assert not bad, bad


def test_chip_ab_takes_the_four_redesigned_kernels():
    four = {"tarmac_step", "tarmac_step_bwd", "flash_gat_fused", "flash_gat_fused_bwd"}
    assert four <= set(chip_ab.KERNELS)
    assert four - set(chip_ab.STEP_WORLDS) == {"flash_gat_fused", "flash_gat_fused_bwd"}


def test_chip_ab_takes_flash_gat_as_the_fifth():
    from uav_bs_ctrl_tpu_torch.ops import gat_kernels
    assert set(chip_ab.KERNELS) == {"flash_gat", "tarmac_step", "tarmac_step_bwd",
                                    "flash_gat_fused", "flash_gat_fused_bwd"}
    assert "flash_gat" not in chip_ab.STEP_WORLDS
    assert chip_ab.KERNELS["flash_gat"] == (gat_kernels.flash_gat,
                                            gat_kernels._FLASH_SIGNATURES)


def test_chip_ab_times_flash_gat_at_serving_shares():
    """Rows of 40 and 512 worlds and more; 'seen' at steps 0 and 25's valid shares."""
    assert {160, 2048, 4096} <= set(chip_ab.FLASH_ROWS)
    assert chip_ab.SERVING_VALID == (0.013, 0.38)


def test_flash_gat_case_draws_slots_valid_above_the_cut():
    import torch
    gen = torch.Generator().manual_seed(0)
    old_device, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        el, er, attn, mask = chip_smoke.flash_gat_case(gen, 64, 50, 256, 4, [1], cut=0.62)
    finally:
        chip_smoke.DEVICE = old_device
    assert el.shape == (64, 50, 256) and er.shape == (64, 256) and attn.shape == (4, 64)
    assert mask[1].sum() == 0
    assert 0.33 < mask.mean().item() < 0.43


def test_chip_ab_scale_leaves_out_the_masked_rows_sentinel():
    import torch
    assert chip_ab.scale(torch.tensor([-1e30, 3.0, -2.0])) == 3.0
    assert chip_ab.scale(torch.tensor([-1e30, 0.5])) == 1.0
    assert chip_ab.scale(torch.tensor([-1e30])) == 1.0


def test_chip_ab_exits_nonzero_without_a_card():
    for name in chip_ab.KERNELS:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), name, "missing.cu"],
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert "ms" not in proc.stdout


def test_chip_ab_tells_the_scratch_less_forward_apart():
    source = (ROOT / "uav_bs_ctrl_tpu_torch" / "ops" / "csrc" / "tarmac_step.cu").read_text()
    assert not chip_ab.unscratched_forward(source)
    old = source.replace("float* h2_out, float* scratch,", "float* h2_out,")
    assert old != source and chip_ab.unscratched_forward(old)


def test_launch_split_averages_each_launch_position_over_the_calls():
    names = ["ns::tarmac_step_bwd_products(Jobs)", "ns::tarmac_step_bwd_attend(float const*)",
             "ns::tarmac_step_bwd_products(Jobs)"]
    events = [(100 * (3 * call + p), 10.0 * (p + 1) + call, names[p])
              for call in range(4) for p in range(3)]
    split = chip_smoke.launch_split(events[::-1], 4)       # any order in, time order out
    assert [name for name, _ in split] == names
    assert [ms for _, ms in split] == pytest.approx([0.0115, 0.0215, 0.0315])
    assert chip_smoke.launch_split(events[:-1], 4) is None   # a call short of one launch


def test_kernel_label_keeps_the_function_and_its_library_tag():
    ns = "(anonymous namespace)::"
    fwd = f"void {ns}step_products<{ns}tarmac_step_fwd>({ns}Jobs)"
    assert chip_smoke.kernel_label(fwd) == "step_products<tarmac_step_fwd>"
    assert chip_smoke.kernel_label(f"{ns}tarmac_step_fwd_head(float const*, int)") == \
        "tarmac_step_fwd_head"
    assert "tarmac_step_bwd" not in fwd and chip_smoke.LIBRARY_TAGS["tarmac_step"] in fwd


def _fake_cuobjdump(tmp_path, functions):
    """A cuobjdump that prints a SASS listing of ``functions`` ({name: HMMA
    lines}), as ``cuobjdump -sass`` lays one out."""
    listing = "".join(f"\t\tFunction : {name}\n" + "        /*0000*/ IMAD.MOV.U32 R1 ;\n"
                      + "        /*0010*/ HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n" * n
                      for name, n in functions.items())
    (tmp_path / "sass.txt").write_text(listing)
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
    tool.chmod(0o755)
    return tmp_path


def test_hmma_counts_counts_each_type_and_each_kernel_without_hmma(tmp_path):
    f32 = "_ZN1_13step_productsINS_15tarmac_step_bwdEfJNS_5TypesIffffEEEEEvNS_4JobsE"
    bf16 = "_ZN1_13step_productsINS_15tarmac_step_bwdE13__nv_bfloat16JNS_5TypesIffS2_fEEEEEv"
    other = "_ZN1_22tarmac_step_bwd_finishIfEEvNS_4SumsE"
    cuda_bin = _fake_cuobjdump(tmp_path, {f32: 48, f32 + "x": 0, bf16: 24, other: 0})
    counts = chip_smoke.hmma_counts({"tarmac_step_bwd": tmp_path / "lib.so"}, cuda_bin)
    assert counts == {"tarmac_step_bwd": {"f32": [2, 48, 1], "bf16": [1, 24, 0]}}


def test_hmma_counts_refuses_a_library_without_one_type(tmp_path):
    f32 = "_ZN1_13step_productsINS_15tarmac_step_fwdEfJNS_5TypesIffffEEEEEvNS_4JobsE"
    cuda_bin = _fake_cuobjdump(tmp_path, {f32: 48})
    with pytest.raises(AssertionError):
        chip_smoke.hmma_counts({"tarmac_step": tmp_path / "lib.so"}, cuda_bin)


def test_f32_step_bound_is_three_tf32_passes_at_the_tf32_peak():
    """An f32 step kernel's operations are bound at 3xTF32's rate on the tensor
    cores, below the CUDA cores' f32 time; bf16's at the bf16 peak; the fused
    GATv2 pair (#2, #3), whose projections run on the tensor cores too, at the
    step kernels' rates; ``flash_gat`` (#1) at the CUDA cores' f32 peak."""
    import torch
    f32, bf16 = chip_smoke.step_peak(torch.float32), chip_smoke.step_peak(torch.bfloat16)
    assert chip_smoke.bound(495e9, 0.0, f32) == (pytest.approx(3.0), "operations")
    assert chip_smoke.bound(989e9, 0.0, bf16) == (pytest.approx(1.0), "operations")
    assert chip_smoke.gat_peak(torch.float32) == f32
    assert chip_smoke.gat_peak(torch.bfloat16) == bf16
    ops = 7.475e8                                       # #5 at R = 256, the 8-UBS width
    flash = chip_smoke.flash_gat_cost(torch.zeros((1, 1, 64)), torch.ones((1, 1)), 1)[2]
    assert chip_smoke.bound(ops, 0.0, f32)[0] < chip_smoke.bound(ops, 0.0, flash)[0]
    assert chip_smoke.bound(1.0, 3.35e9, f32) == (pytest.approx(1.0), "bytes")


def test_chip_ab_times_the_step_kernels_at_the_three_row_counts_and_the_host_step():
    import numpy as np
    old_device, chip_smoke.DEVICE = chip_smoke.DEVICE, "cpu"
    try:
        labels = [label for label, _ in chip_ab.step_cases("tarmac_step",
                                                           np.random.default_rng(0))]
    finally:
        chip_smoke.DEVICE = old_device
    assert {"R=256", "R=2048", "R=4096"} <= set(labels)
    assert any(label.startswith("R=4 ") for label in labels)
    assert {w * 8 for w in chip_ab.STEP_WORLDS["tarmac_step_bwd"]} == {256, 2048, 4096}
    assert {n for n, *_ in chip_ab.HOST_GAT} == {1, 4}
