"""The rules of the PyTorch/CUDA port (paddle_tpu_torch), checked on the
CPU: it imports neither JAX nor the JAX package; its entry points run on
the card unless asked for the CPU; its kernel wrappers refuse what their
kernels do not take and never fall back; chip_smoke.py fails without a
card; the interpreter names a failing op; assign_value copies from the
host once; and chip_smoke's main-path runs (training, serving) go end to
end at a tiny size on the CPU."""
import glob
import inspect
import json
import os
import re
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
        "import paddle_tpu_torch.inference, paddle_tpu_torch.serving.engine\n"
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


def test_predictor_defaults_to_the_card(monkeypatch, tmp_path):
    """inference.Predictor with no place means CUDAPlace(0) too: without a
    CUDA device it raises before anything is read."""
    from paddle_tpu_torch.inference import Predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(str(tmp_path))


def test_assign_value_copies_from_the_host_once(monkeypatch):
    """assign_value makes its tensor on an op's first run and hands the
    same one out after, with no host copy (a copy from the host cannot be
    captured into a CUDA graph)."""
    prog = pt.Program()
    with pt.program_guard(prog, pt.Program()):
        out = layers.assign(np.arange(6, dtype=np.int64).reshape(2, 3))
    cpu = torch.device("cpu")
    with torch.inference_mode():
        first = run_block(prog.global_block(), {}, cpu)[out.name]
    assert not first.is_inference()
    monkeypatch.setattr(torch, "from_numpy", None)   # any call would fail
    again = run_block(prog.global_block(), {}, cpu)[out.name]
    assert again is first
    np.testing.assert_array_equal(again.numpy(), np.arange(6).reshape(2, 3))


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
        kc = _meta(2, 64, 4, 128, dtype=torch.float16)
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
    K1's inputs: fp32 (or bf16, for their twins), head dim 64 or 128, a
    contiguous head dim, 16-byte aligned rows, one CUDA device; off the
    CPU it raises on anything else."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD", "1" if fused else "0")
    shape = (2, 16, 4, 64)
    q = k = v = out = do = _meta(*shape)
    lse = _meta(8, 1, 16)
    if case == "dtype":
        q = k = v = out = do = _meta(*shape, dtype=torch.float16)
    elif case == "head_dim":
        q = k = v = out = do = _meta(2, 16, 4, 96)
    elif case == "strides":
        k = _meta(2, 16, 64, 4).transpose(2, 3)
    elif case == "alignment":
        q = _meta_offset(*shape)
    with pytest.raises(exc, match=match):
        pt_attn.flash_attention_bwd(q, k, v, out, lse, do, causal=True)


def _meta_strided_bf16(b, t, h, d, pad):
    """A BTHD bf16 view whose time stride is h * d + pad elements."""
    return _meta(b, t, h * d + pad, dtype=torch.bfloat16)[
        :, :, :h * d].view(b, t, h, d)


@pytest.mark.parametrize("entry", ["fwd", "bwd", "bwd_fused"])
@pytest.mark.parametrize("case, exc, match", [
    ("strides", ValueError, "multiples of 8"),
    ("odd_stride", ValueError, "multiples of 8"),
    ("alignment", ValueError, "16-byte aligned"),
    ("head_dim", ValueError, "head dim"),
    ("mixed", TypeError, "where q is torch.bfloat16"),
    ("device", ValueError, "is on meta"),
])
def test_bf16_wrappers_refuse_what_their_kernels_do_not_take(
        monkeypatch, entry, case, exc, match):
    """K1-bf16, K2-bf16 and K4-bf16 read rows with 16-byte copies: bf16
    strides that are multiples of 8 values (a stride of 4 more, which
    fp32 takes, or an odd one is refused), 16-byte aligned rows, head dim
    64 or 128, one dtype for all inputs; off the CPU the wrappers raise
    on anything else."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_FUSED_BWD",
                       "1" if entry == "bwd_fused" else "0")
    bf = torch.bfloat16
    shape = (2, 16, 4, 64)
    q = k = v = out = do = _meta(*shape, dtype=bf)
    if case == "strides":
        k = _meta_strided_bf16(2, 16, 4, 64, 4)
    elif case == "odd_stride":
        v = _meta_strided_bf16(2, 16, 4, 64, 1)
    elif case == "alignment":
        # (q itself is pre-scaled into a fresh tensor before the kernel)
        k = _meta(int(np.prod(shape)) + 4, dtype=bf)[4:].view(shape)
    elif case == "head_dim":
        q = k = v = out = do = _meta(2, 16, 4, 96, dtype=bf)
    elif case == "mixed":
        v = _meta(*shape)
    with pytest.raises(exc, match=match):
        if entry == "fwd":
            pt_attn.flash_attention_fwd(q, k, v, causal=True)
        else:
            pt_attn.flash_attention_bwd(q, k, v, out, _meta(8, 1, 16), do,
                                        causal=True)
    # the bf16 kernels' own wrappers take bf16 only
    with pytest.raises(TypeError, match="bfloat16"):
        pt_attn.flash_attention_fwd_bf16(*(_meta(*shape),) * 3)


def test_kernel_wrappers_have_no_fallback():
    """No try/except anywhere a wrapper could swallow a kernel failure
    and run the plain version instead: not in the fp32 kernels' wrappers,
    not in their bf16 twins', each of which counts its own launches."""
    for mod in (pt_attn, pt_kv):
        with open(mod.__file__) as f:
            src = f.read()
        assert "try:" not in src and "except" not in src, mod.__name__
    for name in ("flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
                 "flash_attention_bwd_dkv_bf16",
                 "flash_attention_bwd_fused_bf16"):
        fn = getattr(pt_attn, name)
        assert isinstance(fn.launches, int), name
        assert "try:" not in inspect.getsource(fn), name


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
    # an AMP program runs: its product takes bf16, its mean fp32
    amp = pt.Program()
    with pt.program_guard(amp, pt.Program()):
        with pt.unique_name.guard():
            a = layers.data(name="a", shape=[2, 6], dtype="float32",
                            append_batch_size=False)
            w = layers.data(name="w", shape=[6, 4], dtype="float32",
                            append_batch_size=False)
            prod = layers.matmul(a, w)
            avg = layers.mean(prod)
    for level in ("O1", "O2"):
        amp.enable_mixed_precision(level=level)
        env = {"a": torch.ones(2, 6), "w": torch.full((6, 4), 0.5)}
        run_block(amp.global_block(), env, torch.device("cpu"))
        assert env[prod.name].dtype == torch.bfloat16
        assert env[avg.name].dtype == torch.float32
        assert float(env[avg.name]) == 3.0


def test_chip_smoke_slice_rehearses_on_cpu(tmp_path):
    """chip_smoke's main-path runs at a tiny size on the CPU, where the
    kernels' plain versions run and no launch is counted: the training
    phase (startup, steps, the kernel, plain, plain-backward,
    fused-backward and BHTD steps from one saved state) and the serving slice (export, load,
    generate, the teacher-forced logits check, the engine line's eager
    and graph-step generates, the predictor line)."""
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
    # the engine line: eager and graph-step generates in turns, the same
    # tokens; the first graph-step generate built both steps, no later
    # one built or captured (nothing is captured on the CPU)
    eng = res["engine"]
    assert eng["tokens_equal"]
    assert eng["traces"] == {"after_eager": 2,
                             "after_first_graph_generate": 2,
                             "after_timed": 2, "after_main_path": 2}
    assert res["main_path"] == {"tokens_equal": True,
                                "captures_or_builds": 0,
                                "prefill_calls": 1, "decode_steps": 5}
    assert len(eng["eager"]["decode_ms_per_token"]) == 2
    assert len(eng["graph"]["decode_ms_per_token"]) == 2
    # memory over buckets: the steps of each bucket stay until the cache
    # is bounded, which evicts the least recently used and holds the rest
    # under the bound
    mem = eng["memory"]
    assert [m["bucket"] for m in mem["unbounded"]] == \
        ["slice", "half_quarter", "quarter_half"]
    assert mem["unbounded"][0]["step_cache_gb"] == mem["slice_step_gb"]
    assert mem["unbounded"][-1]["step_cache_gb"] > mem["slice_step_gb"]
    assert mem["bounded"][-1]["evictions"] > 0
    assert all(m["step_cache_gb"] <= mem["bound_gb"]
               for m in mem["bounded"])
    # the predictor line: the prefill export at the slice's bucket
    pr = res["predictor"]
    assert pr["export"] == [4, 32]
    assert pr["graph_vs_eager_max_abs"] == 0.0
    assert pr["vs_decode_prefill_equal"]
    for name in ("model", "predictor_model"):
        assert not os.path.exists(os.path.join(str(tmp_path), name))


def test_chip_smoke_train_amp_rehearses_on_cpu(tmp_path):
    """chip_smoke's bf16 AMP phase at a tiny size on the CPU: built as
    bench.py builds its LM (minimize, then O2), steps, then the kernel,
    plain-attention, fused-backward, O1 and fp32 steps from one saved
    state; every gate holds (on the CPU the kernel path is the plain
    path) and no launch is counted."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    tcfg = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32,
                d_inner=64, max_len=16)
    tr = chip_smoke.run_train_amp(tcfg, 2, 16, 1e-2, 1, 2, 0, pt.CPUPlace(),
                                  str(tmp_path))
    json.dumps(tr)
    none = dict.fromkeys(chip_smoke.FP32_KERNELS + chip_smoke.BF16_KERNELS,
                         0)
    for key in ("launches_per_step", "kernel_step_launches",
                "fused_bwd_launches", "o1_launches"):
        assert tr[key] == none, key
    assert len(tr["losses"]) == 3 and np.all(np.isfinite(tr["losses"]))
    assert tr["losses"][-1] < tr["losses"][0]
    for key in ("kernels_vs_plain", "fused_bwd_vs_plain"):
        assert tr[key]["ok"] and tr[key]["loss_ratio"] == 0.0, tr[key]
    # bf16 moves the step from fp32's, and O2 more than O1 here
    assert 0 < tr["o1_vs_fp32_grad_rel"] < tr["o2_vs_fp32_grad_rel"] < 0.1


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
        "        /*0030*/  STL.64 [R1+0x8], R24 ;",
        "        /*0040*/  LDL.64 R24, [R1+0x8] ;",
        "        /*0050*/  LDL R26, [R1+0x10] ;",
        "\t\tFunction : %s" % other,
        "        /*0010*/  STL [R1], R2 ;",
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
        "flash_bwd_dq<64>": {"tc_instructions": 2, "hgmma": 0, "hmma": 2,
                             "ldl": 0, "stl": 0, "regs": 162, "stack": 0,
                             "local": 0},
        "flash_bwd_dkv<128>": {"tc_instructions": 1, "hgmma": 1, "hmma": 0,
                               "ldl": 2, "stl": 1, "regs": 238, "stack": 8,
                               "local": 32},
    }
    # the bf16 twins: bf16 HMMA counted, TF32 and fp16 ones not
    fwd64 = ("_ZN50_GLOBAL__N__ae332e6c_17_flash_fwd_bf16_cu_48fe48b521flash"
             "_fwd_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfPKiiiiNS"
             "_10FwdStridesEi")
    sass_bf16 = "\n".join([
        "\t\tFunction : %s" % fwd64,
        "        /*0010*/  HMMA.16816.F32.BF16 R8, R4, R12, R8 ;",
        "        /*0020*/  HMMA.16816.F32.BF16 R8, R16, R12, R8 ;",
        "        /*0030*/  HMMA.16816.F32 R8, R16, R12, R8 ;",
        "        /*0040*/  HMMA.1688.F32.TF32 R8, R16, R12, R8 ;",
        "        /*0050*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0060*/  HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR8], R24 ;",
        "\t\tFunction : %s" % dq64,
        "        /*0010*/  HMMA.16816.F32.BF16 R8, R4, R12, R8 ;",
    ])
    res_bf16 = " Function %s:\n  REG:165 STACK:0 SHARED:0 LOCAL:0" % fwd64
    got = chip_smoke.parse_sass(sass_bf16, res_bf16, ("flash_fwd_bf16",),
                                "BF16")
    assert got == {"flash_fwd_bf16<64>": {"tc_instructions": 4, "hgmma": 2,
                                          "hmma": 2, "ldl": 0, "stl": 0,
                                          "regs": 165, "stack": 0,
                                          "local": 0}}
    # the bound: fp32-accurate products at the 3xTF32 tensor-core rate
    # (495 / 3 TFLOP/s) by default, at the CUDA cores' 67 on request
    ms, by = chip_smoke.bound(495e9, 1e6)
    assert by == "operations" and abs(ms - 3.0) < 1e-9
    ms, by = chip_smoke.bound(67e9, 1e6, chip_smoke.PEAK_FP32_FLOPS)
    assert by == "operations" and abs(ms - 1.0) < 1e-9
    ms, by = chip_smoke.bound(1e9, 3.35e9)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    # bf16 products at the dense bf16 rate; bf16 values count 2 bytes
    ms, by = chip_smoke.bound(989e9, 1e6, chip_smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and abs(ms - 1.0) < 1e-9
    f32 = chip_smoke.flash_work(2, 2, 64, 64, 64, True)
    b16 = chip_smoke.flash_work(2, 2, 64, 64, 64, True, itemsize=2)
    assert f32[0] == b16[0] and b16[1] == f32[1] / 2 + 2 * 2 * 2 * 64
    # K4-bf16's fp32 adds into dq: at the causal training shape each
    # (b, h) adds 4608 rows of Dh values (128-key tiles from the diagonal
    # on), 4.5x the fp32 dq buffer; a length-0 batch adds nothing
    assert chip_smoke.fused_dq_reduce_bytes(16, 16, 1024, 1024, 64,
                                            True) == 4 * 64 * 4608 * 256
    assert chip_smoke.fused_dq_reduce_bytes(8, 8, 1024, 1024, 128,
                                            True) == 4 * 128 * 4608 * 64
    assert chip_smoke.fused_dq_reduce_bytes(2, 1, 200, 200, 128, False,
                                            [0, 129]) == 4 * 128 * 200 * 2
    # --k4-ablations: each part it leaves out is one the kernel's body
    # knows by its K4_BF16_OMIT value
    with open(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                           "flash_bwd_kv_bf16.cuh")) as f:
        body = f.read()
    omit = set(int(n) for n in re.findall(r"K4_BF16_OMIT (?:==|>=) (\d)",
                                          body))
    assert sorted(chip_smoke.K4_ABLATIONS.values()) == [0] + sorted(omit)


def _with_includes(path, skip=()):
    """A CUDA source's text and that of every header it includes with
    quotes, from the same directory, recursively; headers named in
    ``skip`` left out."""
    with open(path) as f:
        text = f.read()
    for name in re.findall(r'#include "([^"]+)"', text):
        if name not in skip:
            text += _with_includes(os.path.join(os.path.dirname(path), name),
                                   skip)
    return text


@pytest.mark.parametrize("source", ["flash_fwd_bf16", "flash_bwd_bf16",
                                    "flash_bwd_fused_bf16"])
def test_bf16_attention_kernels_are_written_for_hopper(source):
    """K1-bf16, K2-bf16 and K4-bf16 multiply by wgmma and copy tiles by TMA
    (tensor maps encoded through the driver entry point, so the build
    links no libcuda, and cached), under warp specialisation; not by
    mma.sync and cp.async. A kernel's own code is its source and the
    kernel headers it includes (K2-bf16 and K4-bf16 share their KV-outer
    body, flash_bwd_kv_bf16.cuh), not sm90.cuh's building blocks. K4-bf16
    adds dq by TMA reductions, not by 8-byte atomics."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    path = os.path.join(csrc, source + ".cu")
    text = _with_includes(path)
    own = _with_includes(path, skip=("sm90.cuh",))
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
    assert "setmaxnreg" in text and "cuTensorMapEncodeTiled" in text
    assert "cudaGetDriverEntryPoint" in text
    assert re.search(r"\bwgmma_(ss|rs)<", own) and "tma_load_4d(" in own
    assert "__grid_constant__ CUtensorMap" in own
    assert "regs_alloc<" in own and "regs_dealloc<" in own
    assert "mma_bf16(" not in own and "cp_async" not in own
    # the host side asks the driver once: maps cached, attributes set once
    assert "allow_smem(" in own and "cudaFuncSetAttribute(" not in own
    assert "unordered_map<MapKey" in text
    assert "atomicAdd(reinterpret_cast<float2*>" not in own
    if source != "flash_fwd_bf16":
        assert '#include "flash_bwd_kv_bf16.cuh"' in own
    if source == "flash_bwd_fused_bf16":
        assert "tma_reduce_add_4d(" in own and "stmatrix_x4_trans(" in own
        assert "cp.reduce.async.bulk.tensor" in text
    assert not os.path.exists(os.path.join(csrc, "bf16_mma.cuh"))
    from paddle_tpu_torch.kernels import _build

    assert source in _build.SOURCES and "-lcuda" not in _build.NVCC_FLAGS


def test_chip_smoke_counts_every_port_kernel_as_attention():
    """chip_smoke's profile calls every kernel that a csrc/*.cu source
    declares "attention", under the name the profiler prints for it (a
    decode kernel once fell into "other"); a cuBLAS sgemm stays
    "products" and an elementwise kernel "other"."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                      r"\([^;{]*?\)\s+)?(\w+)\s*\(")
    names = {}
    for path in glob.glob(os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            for name in decl.findall(f.read()):
                names[name] = os.path.basename(path)[:-3]
    assert "decode_attn" in names.values() and len(names) >= 5, names
    for name, src in names.items():
        printed = ("void (anonymous namespace)::%s<128>(float const*, "
                   "float const*, float const*, int const*, float*)" % name)
        assert chip_smoke._kernel_kind(printed) == "attention", printed
        assert chip_smoke._port_source(printed) == src
    assert chip_smoke._kernel_kind(
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>"
        "(cutlass_80_simt_sgemm_128x32_8x5_nn_align1::Params)") == "products"
    assert chip_smoke._kernel_kind(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>>(int, ...)") == "other"
