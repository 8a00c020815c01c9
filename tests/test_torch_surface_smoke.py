"""chip_smoke's training-surface phases (moe, nmt_noam, optimizers) at a
tiny size on the CPU, where the kernel path is the plain path: every gate
the card holds them to holds here, and no kernel launch is counted.

- moe: the MoE LM (4 experts) in bf16 O2, timed in turns; each layer's
  kept share in (0, 1]; at one layer, the graph step equal to the eager
  step bitwise and the plain attention's step (routing pinned, no flip
  here) equal to the kernel step's.
- nmt_noam: the Transformer under noam_decay and Adam(0.9, 0.98, 1e-9):
  every step's lr within 1e-6 of d^-0.5 min(s^-0.5, s w^-1.5), and
  run_loop(2) equal to 2 runs bitwise, the step counter advanced by 2.
- optimizers: every recipe's losses finite, its graph step equal to its
  eager step bitwise, ModelAverage's apply and restore in place (the
  replay after restore equal to the eager step from that state), and
  every optimizer op within 1e-6 of its float64 evaluation.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
try:
    import chip_smoke  # noqa: E402
finally:
    sys.path.remove(ROOT)

TCFG = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_len=16)
NONE = dict.fromkeys(chip_smoke.FP32_KERNELS + chip_smoke.BF16_KERNELS, 0)


def test_moe_phase_rehearses_on_cpu(tmp_path):
    r = chip_smoke.run_moe(dict(TCFG, moe_experts=4), 2, 16, 1e-2, 1, 1, 0,
                           pt.CPUPlace(), str(tmp_path), compare_layers=1)
    json.dumps(r)
    assert r["launches_per_step"] == NONE == r["main_path_host_launches"]
    assert r["capacity"] == 16 and r["experts"] == 4
    assert len(r["kept_share_by_layer"]) == TCFG["n_layer"]
    assert all(0 < s <= 1 for s in r["kept_share_by_layer"])
    assert r["graph_vs_eager"]["bitwise"]
    assert r["kernels_vs_plain"]["ok"]
    assert r["kernels_vs_plain"]["loss_ratio"] == 0.0
    flips = r["routing_flips"]
    assert flips["plain"] == 0 and flips["choices"] == 2 * 2 * 16
    assert len(flips["plain_by_round"]) == 2   # one layer, k = 2


def test_nmt_noam_phase_rehearses_on_cpu(tmp_path):
    cfg = dict(src_vocab_size=50, tgt_vocab_size=60, n_layer=1, n_head=2,
               d_model=32, d_inner=64)
    r = chip_smoke.run_nmt_noam(cfg, 3, 16, 4, 0, pt.CPUPlace(),
                                str(tmp_path), 3, 2)
    json.dumps(r)
    assert len(r["lrs"]) == 4 and r["lr_rel_err_max"] <= 1e-6
    np.testing.assert_allclose(
        r["lrs"], chip_smoke.noam_lr(32, chip_smoke.NOAM_WARMUP,
                                     [1, 2, 3, 4]), rtol=1e-6)
    lvr = r["loop_vs_runs"]
    assert lvr["bitwise"] and lvr["counter_after"] == 6
    assert r["launches_per_step"] == NONE == r["main_path_host_launches"]


def test_optimizers_phase_rehearses_on_cpu(tmp_path):
    r = chip_smoke.run_optimizers(dict(TCFG, n_layer=1), 2, 16, 0,
                                  pt.CPUPlace(), str(tmp_path), 1, 1)
    json.dumps(r)
    assert set(r["recipes"]) == set(chip_smoke.OPT_RECIPES)
    for name, got in r["recipes"].items():
        assert got["graph_vs_eager"]["bitwise"], name
        assert got["ops"], name
    assert r["recipes"]["Momentum_LARS"]["ops"] == ["momentum"]
    ma = r["recipes"]["Adam_ModelAverage"]["model_average"]
    assert ma["apply_moved_params"] and ma["restore_bitwise"]
    assert ma["replay_vs_eager"]["bitwise"]
    assert set(r["op_rel_err"]) == set(chip_smoke.OPT_OP_TYPES)
    assert max(r["op_rel_err"].values()) <= chip_smoke.OPT_OP_RTOL
