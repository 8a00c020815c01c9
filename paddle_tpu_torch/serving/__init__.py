"""Serving of paddle_tpu_torch: KV-cache decode (DecodePredictor), on the
Engine (engine.py): one GraphStep per step program and feed signature,
captured as a CUDA graph on the card and replayed."""
from .decode import DecodeConfig, DecodePredictor, save_decode_model
from .engine import Engine, GraphStep

__all__ = ["DecodeConfig", "DecodePredictor", "Engine", "GraphStep",
           "save_decode_model"]
