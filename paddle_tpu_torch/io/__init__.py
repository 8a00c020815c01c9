"""Inference-model persistence (counterpart of paddle_tpu/io/__init__.py).

The directory layout is the JAX package's, so one export loads in either
package: ``__model__`` holds the pruned program as JSON with its feed and
fetch names, ``__params__.npz`` the parameters it reads (``/`` in a name
escaped as ``%2F``). ``state_from_numpy`` turns parameters held as numpy
arrays — what the JAX package saves, or holds once fetched to the host —
into the port's tensors on a place.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.core import Program, Variable, default_main_program
from ..framework.scope import CUDAPlace, Place, Scope, global_scope

__all__ = ["save_inference_model", "load_inference_model",
           "state_from_numpy", "is_persistable"]

_MODEL_FILE = "__model__"
_PARAMS_FILE = "__params__.npz"


def is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def _np_name(name: str) -> str:
    # var names are filesystem-safe except path separators
    return name.replace("/", "%2F")


def _npz_path(dirname: str, filename: str) -> str:
    if not filename.endswith(".npz"):
        filename += ".npz"
    return os.path.join(dirname, filename)


def _as_numpy(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _place_of(executor) -> Place:
    """The place to load onto: an explicit Place, an object carrying a
    ``place``, else the card."""
    if isinstance(executor, Place):
        return executor
    place = getattr(executor, "place", None)
    return place if isinstance(place, Place) else CUDAPlace(0)


def state_from_numpy(arrays: Dict[str, np.ndarray], place: Place
                     ) -> Dict[str, torch.Tensor]:
    """Name -> numpy array (e.g. the JAX package's parameters) -> name ->
    tensor on ``place``, each a copy the port owns."""
    device = place.torch_device()
    return {name: torch.from_numpy(np.array(val, copy=True)).to(device)
            for name, val in arrays.items()}


def _prune_for_targets(program: Program, target_names: List[str]) -> Program:
    """Backward slice: keep only ops whose outputs (transitively) feed the
    targets. Plays the role of the reference's Program.prune()."""
    pruned = program.clone(for_test=True)
    gb = pruned.global_block()
    needed = set(target_names)
    kept = []
    for op in reversed(gb.ops):
        if any(n in needed for n in op.output_arg_names):
            kept.append(op)
            needed.update(op.input_arg_names)
    gb.ops = list(reversed(kept))
    pruned._bump()
    return pruned


def save_inference_model(
    dirname: str,
    feeded_var_names: Sequence[str],
    target_vars: Sequence,
    executor=None,
    main_program: Optional[Program] = None,
    model_filename: Optional[str] = None,
    params_filename: Optional[str] = None,
    scope: Optional[Scope] = None,
):
    """Reference: io.py:save_inference_model. Writes the pruned inference
    program as JSON plus the parameters it reads, taken from ``scope`` (or
    the global scope) as tensors or numpy arrays. ``executor`` is accepted
    for the reference's signature and not used."""
    program = main_program if main_program is not None else default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    target_names = [v.name if isinstance(v, Variable) else str(v) for v in target_vars]
    pruned = _prune_for_targets(program, target_names)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": target_names,
        "program": pruned.to_dict(),
    }
    with open(os.path.join(dirname, model_filename or _MODEL_FILE), "w") as f:
        json.dump(meta, f)

    scope = scope if scope is not None else global_scope()
    used = {n for blk in pruned.blocks for op in blk.ops for n in op.input_arg_names}
    arrays = {}
    for var in pruned.list_vars():
        if not (is_persistable(var) and var.name in used):
            continue
        val = scope.find_var(var.name)
        if val is None:
            raise RuntimeError("variable %r has no value in scope" % var.name)
        arrays[_np_name(var.name)] = _as_numpy(val)
    np.savez(_npz_path(dirname, params_filename or _PARAMS_FILE), **arrays)
    return target_names


def load_inference_model(
    dirname: str,
    executor=None,
    model_filename: Optional[str] = None,
    params_filename: Optional[str] = None,
    scope: Optional[Scope] = None,
    place: Optional[Place] = None,
):
    """Reference: io.py:load_inference_model -> (program,
    feed_target_names, fetch_targets). The parameters land in ``scope``
    (or the global scope) as tensors on ``place`` — by default the place
    ``executor`` names, else the card."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    scope = scope if scope is not None else global_scope()
    path = _npz_path(dirname, params_filename or _PARAMS_FILE)
    if os.path.exists(path):
        with np.load(path) as npz:
            params = {key.replace("%2F", "/"): npz[key] for key in npz.files}
        place = place if place is not None else _place_of(executor)
        for name, val in state_from_numpy(params, place).items():
            scope.set_var(name, val)
    fetch_targets = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, list(meta["feed_names"]), fetch_targets


# reader-op pipeline (py_reader / double_buffer / recordio readers)
from . import reader  # noqa: E402,F401
from .reader import EOFException  # noqa: E402,F401
# multiprocess input fast path (shared-memory zero-copy batches)
from . import dataloader  # noqa: E402,F401
from .dataloader import DataLoader  # noqa: E402,F401
