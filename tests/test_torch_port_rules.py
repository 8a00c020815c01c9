"""The rules of the PyTorch/CUDA port (paddle_tpu_torch), checked on the
CPU: it imports neither JAX nor the JAX package; its entry points run on
the card unless asked for the CPU; its kernel wrappers refuse what their
kernels do not take and never fall back; chip_smoke.py fails without a
card; the interpreter names a failing op; and chip_smoke's main-path
runs (training, serving) go end to end at a tiny size on the CPU."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import layers  # noqa: E402
from paddle_tpu_torch.framework.interpreter import (  # noqa: E402
    TraceError, run_block)
from paddle_tpu_torch.ops import attention as pt_attn  # noqa: E402
from paddle_tpu_torch.ops import kv_cache as pt_kv  # noqa: E402
from paddle_tpu_torch.serving.decode import DecodePredictor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving.decode\n"
        "import paddle_tpu_torch.framework.interpreter\n"
        "import paddle_tpu_torch.kernels, paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.executor, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=_cpu_env())
    assert r.returncode == 0, r.stdout + r.stderr


def test_decode_predictor_defaults_to_the_card(monkeypatch, tmp_path):
    """No place means CUDAPlace(0); without a CUDA device that raises —
    before anything is read — and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodePredictor(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.CUDAPlace(0).torch_device()
    assert pt.CPUPlace().torch_device() == torch.device("cpu")


def test_executor_defaults_to_the_card(monkeypatch):
    """Executor() means CUDAPlace(0) — the JAX package's Executor defaults
    to the CPU, the port's does not — and raises without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor()
    exe = pt.Executor(pt.CPUPlace())
    assert exe.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="transpiler"):
        pt.Executor(pt.CPUPlace(), opt_level=1)
    with pytest.raises(NotImplementedError, match="run_loop"):
        exe.run_loop(pt.Program())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_offset(*shape):
    """A contiguous view that starts one float past its storage: its rows
    are not 16-byte aligned."""
    n = int(np.prod(shape))
    return _meta(n + 1)[1:].view(shape)


@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32"),
    ("head_dim", ValueError, "head dim"),
    ("mismatch", ValueError, "do not agree"),
    ("strides", ValueError, "contiguous head dim"),
    ("alignment", ValueError, "16-byte aligned"),
    ("device", ValueError, "is on meta"),
])
def test_flash_wrapper_refuses_what_k1_does_not_take(case, exc, match):
    """Off the CPU the wrapper validates and then launches or raises; meta
    tensors reach its validation without a card."""
    q = k = v = _meta(2, 16, 4, 128)
    if case == "dtype":
        q = k = v = _meta(2, 16, 4, 128, dtype=torch.float64)
    elif case == "head_dim":
        q = k = v = _meta(2, 16, 4, 96)
    elif case == "mismatch":
        k = _meta(2, 16, 2, 128)
    elif case == "strides":
        q = _meta(2, 16, 128, 4).transpose(2, 3)
    elif case == "alignment":
        v = _meta_offset(2, 16, 4, 128)
    with pytest.raises(exc, match=match):
        pt_attn.flash_attention_fwd(q, k, v, causal=True)


@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32"),
    ("head_dim", ValueError, "head dim"),
    ("mismatch", ValueError, "do not agree"),
    ("layout", ValueError, "contiguous"),
    ("alignment", ValueError, "16-byte aligned"),
    ("device", ValueError, "is on meta"),
])
def test_decode_wrapper_refuses_what_k3_does_not_take(case, exc, match):
    q, kc, vc = _meta(2, 1, 4, 128), _meta(2, 64, 4, 128), \
        _meta(2, 64, 4, 128)
    lens = torch.tensor([3, 64], dtype=torch.int32)
    if case == "dtype":
        kc = _meta(2, 64, 4, 128, dtype=torch.bfloat16)
    elif case == "head_dim":
        q, kc, vc = _meta(2, 1, 4, 32), _meta(2, 64, 4, 32), \
            _meta(2, 64, 4, 32)
    elif case == "mismatch":
        vc = _meta(2, 32, 4, 128)
    elif case == "layout":
        kc = _meta(2, 4, 64, 128).transpose(1, 2)
    elif case == "alignment":
        vc = _meta_offset(2, 64, 4, 128)
    with pytest.raises(exc, match=match):
        pt_kv.decode_attention(q, kc, vc, lens)


@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K4"])
@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32"),
    ("head_dim", ValueError, "head dim"),
    ("strides", ValueError, "contiguous head dim"),
    ("alignment", ValueError, "16-byte aligned"),
    ("device", ValueError, "is on meta"),
])
def test_backward_wrappers_refuse_what_k2_and_k4_do_not_take(
        monkeypatch, case, exc, match, fused):
    """The backward (K2, or K4 under PADDLE_TPU_FLASH_FUSED_BWD=1) takes
    K1's inputs: fp32, head dim 64 or 128, a contiguous head dim, 16-byte
    aligned rows, one CUDA device; off the CPU it raises on anything
    else."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    shape = (2, 16, 4, 64)
    q = k = v = out = do = _meta(*shape)
    lse = _meta(8, 1, 16)
    if case == "dtype":
        q = _meta(*shape, dtype=torch.bfloat16)
    elif case == "head_dim":
        q = k = v = out = do = _meta(2, 16, 4, 96)
    elif case == "strides":
        k = _meta(2, 16, 64, 4).transpose(2, 3)
    elif case == "alignment":
        q = _meta_offset(*shape)
    with pytest.raises(exc, match=match):
        pt_attn.flash_attention_bwd(q, k, v, out, lse, do, causal=True)


def test_kernel_wrappers_have_no_fallback():
    """No try/except anywhere a wrapper could swallow a kernel failure
    and run the plain version instead."""
    for mod in (pt_attn, pt_kv):
        with open(mod.__file__) as f:
            src = f.read()
        assert "try:" not in src and "except" not in src, mod.__name__


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=_cpu_env())
    assert r.returncode != 0 and '"ok"' not in r.stdout
    # alone, without the rest of the repo, it fails as well
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=_cpu_env())
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_interpreter_names_the_failing_op():
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        with pt.unique_name.guard():
            x = layers.data(name="x", shape=[2, 6], dtype="float32",
                            append_batch_size=False)
            y = layers.reshape(x, shape=[4, 4])
    env = {"x": torch.zeros(2, 6)}
    with pytest.raises(TraceError, match="reshape.*\\(2, 6\\)") as ei:
        run_block(prog.global_block(), env, torch.device("cpu"))
    assert "'shape': [4, 4]" in str(ei.value)
    assert y.name not in env
    # training runs now; mixed precision is still a later slice
    prog.global_block().ops.pop(0)
    prog.enable_mixed_precision()
    with pytest.raises(NotImplementedError, match="bf16"):
        run_block(prog.global_block(), env, torch.device("cpu"))


def test_chip_smoke_slice_rehearses_on_cpu(tmp_path):
    """chip_smoke's main-path runs at a tiny size on the CPU, where the
    kernels' plain versions run and no launch is counted: the training
    phase (startup, steps, the kernel, plain, plain-backward,
    fused-backward and BHTD steps from one saved state) and the serving slice (export, load,
    generate, the teacher-forced logits check)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    tcfg = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32,
                d_inner=64, max_len=16)
    tr = chip_smoke.run_train(tcfg, 2, 16, 1e-2, 1, 2, 0, pt.CPUPlace(),
                              str(tmp_path))
    json.dumps(tr)
    none = {"K1": 0, "K2-dq": 0, "K2-dkv": 0, "K4": 0}
    assert tr["launches_per_step"] == none
    assert tr["fused_bwd_launches"] == none == tr["bhtd_launches"]
    assert len(tr["losses"]) == 3 and np.all(np.isfinite(tr["losses"]))
    assert tr["losses"][-1] < tr["losses"][0]
    for key in ("kernels_vs_plain", "bwd_kernels_vs_plain_bwd",
                "fused_bwd_vs_kernels", "bhtd_vs_bthd"):
        assert tr[key]["ok"], tr[key]
    # on the CPU the kernel path is the plain path
    assert tr["kernels_vs_plain"]["loss_rel_err"] == 0.0
    assert tr["kernels_vs_plain"]["param_max_abs_err"] == 0.0
    cfg = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32, d_inner=64,
               max_len=128)
    res = chip_smoke.run_slice(cfg, np.array([20, 9, 13]), 6, 0,
                               pt.CPUPlace(), str(tmp_path))
    json.dumps(res)
    assert res["launches"] == {"K1": 0, "K3": 0}
    assert res["prefill_calls"] == 1 and res["decode_steps"] == 5
    assert res["replay_matches_generate"] and res["logits_finite"]
    assert res["logits_max_abs_err"] == 0.0
    assert not os.path.exists(os.path.join(str(tmp_path), "model"))


def test_chip_smoke_counts_tensor_core_instructions_per_kernel():
    """chip_smoke's SASS check: cuobjdump's -sass and -res-usage output
    (abridged, in the toolkit's format) turn into each named kernel's TF32
    tensor-core instruction count (a tensor-core instruction of another
    type does not count), registers, stack and local memory, per head-dim
    instantiation; other kernels are left out."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    dq64 = ("_ZN45_GLOBAL__N__8bcb2f8f_12_flash_bwd_cu_26e75b9b19flash_bwd_"
            "dq_kernelILi64EEEvPKfS2_S2_S2_S2_S2_PfPKiiiiNS_7StridesEfi")
    dkv128 = ("_ZN45_GLOBAL__N__8bcb2f8f_12_flash_bwd_cu_26e75b9b20flash_bwd"
              "_dkv_kernelILi128EEEvPKfS2_S2_S2_S2_S2_PfS3_PKiiiiNS_7Strides"
              "Efi")
    other = "_Z12other_kernelPf"
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : %s" % dq64,
        "        /*0010*/  LDSM.16.M88.4 R4, [R2] ;",
        "        /*0020*/  HMMA.1688.F32.TF32 R8, R4, R12, R8 ;",
        "        /*0030*/  HMMA.1688.F32.TF32 R8, R16, R12, R8 ;",
        "        /*0040*/  HMMA.16816.F32 R8, R16, R12, R8 ;",
        "\t\tFunction : %s" % dkv128,
        "        /*0010*/  HGMMA.64x64x8.F32.TF32 R24, gdesc[UR4], R24 ;",
        "        /*0020*/  FADD R1, R2, R3 ;",
        "\t\tFunction : %s" % other,
        "        /*0010*/  HMMA.1688.F32.TF32 R8, R4, R12, R8 ;",
    ])
    res_usage = "\n".join([
        " Function %s:" % dq64,
        "  REG:162 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:784 TEXTURE:0",
        " Function %s:" % dkv128,
        "  REG:238 STACK:8 SHARED:0 LOCAL:32 CONSTANT[0]:792 TEXTURE:0",
        " Function %s:" % other,
        "  REG:16 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:356 TEXTURE:0",
    ])
    got = chip_smoke.parse_sass(sass, res_usage,
                                ("flash_bwd_dq", "flash_bwd_dkv"))
    assert got == {
        "flash_bwd_dq<64>": {"tc_instructions": 2, "regs": 162, "stack": 0,
                             "local": 0},
        "flash_bwd_dkv<128>": {"tc_instructions": 1, "regs": 238,
                               "stack": 8, "local": 32},
    }
    # the bound: fp32-accurate products at the 3xTF32 tensor-core rate
    # (495 / 3 TFLOP/s) by default, at the CUDA cores' 67 on request
    ms, by = chip_smoke.bound(495e9, 1e6)
    assert by == "operations" and abs(ms - 3.0) < 1e-9
    ms, by = chip_smoke.bound(67e9, 1e6, chip_smoke.PEAK_FP32_FLOPS)
    assert by == "operations" and abs(ms - 1.0) < 1e-9
    ms, by = chip_smoke.bound(1e9, 3.35e9)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
