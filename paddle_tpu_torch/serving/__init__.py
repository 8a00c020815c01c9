"""Serving of paddle_tpu_torch: KV-cache decode (DecodePredictor, and
DecodeServer's continuous batching), on the Engine (engine.py): one
GraphStep per step program and feed signature, captured as a CUDA graph
on the card and replayed."""
from .decode import (DecodeConfig, DecodePredictor, DecodeServer,
                     save_decode_model)
from .engine import Engine, GraphStep

__all__ = ["DecodeConfig", "DecodePredictor", "DecodeServer", "Engine",
           "GraphStep", "save_decode_model"]
