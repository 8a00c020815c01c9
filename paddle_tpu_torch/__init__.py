"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style Program/Block/Operator IR and ``layers.*`` builders as
the JAX package, run eagerly over torch tensors by framework/interpreter.py.
Every TPU (Pallas) kernel on a ported path has a hand-written CUDA twin for
Hopper under csrc/, built on first use (kernels/_build.py). This package
imports torch and numpy, never jax and never paddle_tpu.

Ported so far: serving the decoder LM (serving/decode.py:
``DecodePredictor.generate``, greedy, top-k or top-p, and the
continuous-batching ``DecodeServer``) through the flash-attention prefill
kernel (K1) and the decode-attention kernel (K3), exported inference
models through ``inference.Predictor`` and its batching
``PredictorServer``, all with their steps captured once per bucket as
CUDA graphs and replayed (serving/engine.py), and training it (``Executor.run`` and ``run_loop`` of
a program built with ``optimizer.Adam(...).minimize``, in fp32 or bf16
AMP, the step captured once as a CUDA graph and replayed, fed by a feed
dict or by the reader ops: ``layers.py_reader`` -> ``batch`` ->
``double_buffer`` -> ``read_file``, or from files on disk:
``recordio_convert`` / ``recordio_writer`` -> ``layers.open_files`` ->
``batch``, or a multiprocess ``layers.data_loader``) through K1 and the
flash-attention backward kernels (K2, or K4 with
``PADDLE_TPU_FLASH_FUSED_BWD=1``), with every optimizer of the JAX
package (and ``ModelAverage``), gradient clipping, weight decay and the
learning-rate schedules (``layers.noam_decay`` ...), and the
mixture-of-experts FFN (``transformer_lm(moe_experts=E)``, routed by
index). The input path's host runtime
(runtime/runtime.cc: recordio, prefetch, channels) is C++, built with g++
on first use.
"""
from . import (backward, clip, framework, inference, initializer, io,
               layers, observability, optimizer, parallel, reader,
               recordio_writer, regularizer, serving)
from .backward import append_backward
from .data_feeder import DataFeeder
from .executor import Executor
from .inference import Predictor, PredictorServer
from .io.dataloader import DataLoader
from .io.reader import EOFException
from .reader import batch
from .runtime.recordio import recordio_convert, recordio_sample_reader
from .serving import DecodePredictor, DecodeServer
from .framework import (
    CPUPlace,
    CUDAPlace,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
    scope_guard,
    unique_name,
)
from .param_attr import ParamAttr

__all__ = [
    "CPUPlace", "CUDAPlace", "DataFeeder", "DataLoader", "DecodePredictor",
    "DecodeServer", "EOFException", "Executor", "ParamAttr", "Predictor",
    "PredictorServer", "Program", "Scope", "append_backward", "backward",
    "batch", "clip", "default_main_program", "default_startup_program",
    "framework", "global_scope", "inference", "initializer", "io",
    "layers", "observability", "optimizer", "parallel", "program_guard",
    "reader",
    "recordio_convert", "recordio_sample_reader", "recordio_writer",
    "regularizer", "scope_guard", "serving", "unique_name",
]
