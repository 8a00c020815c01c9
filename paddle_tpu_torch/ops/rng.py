"""Counter-based random bits that a captured CUDA graph can replay: the
draws of dropout and of attention dropout.

A replayed graph repeats every host-side value of its capture, so these
draws take nothing from the host. The step's random counter is a device
tensor ``[seed, step]`` (int64) that the executor writes before each
replay (a feed of the step, ``executor.RNG_FEED``). An op's key is a
32-bit hash of that counter and of a salt the host knows when the program
is built (``mix`` of the block, the op's position, the draw number),
computed on the device (``op_key``); ``mix`` also seeds the host-side
generators of the random ops (framework/interpreter.py). A draw's bits
are a hash of (key, element index), computed elementwise
(``keep_mask``). The same (seed, step, op, draw)
gives the same bits through the graph and op by op, on the card and on
the CPU; the bits differ from JAX's PRNG, so compare statistically.

The hash is murmur3's 32-bit finalizer. Keys are mixed in int64 tensors
holding uint32 values (``sampling._mix32``, products split so nothing
overflows); the per-element hash, where bytes count, runs in int32, whose
products wrap modulo 2**32 on both devices (a test holds it to numpy's
uint32 arithmetic).
"""
from __future__ import annotations

import torch

from .sampling import _M32, _mix32

# murmur3's finalizer constants and the golden-ratio increment, as int32
# values (the uint32 constants less 2**32)
_C1 = 0x85EBCA6B - (1 << 32)
_C2 = 0xC2B2AE35 - (1 << 32)
_GOLDEN = 0x9E3779B1 - (1 << 32)
_MASK64 = (1 << 64) - 1


def mix(*vals: int) -> int:
    """A 63-bit value from a tuple of host integers (splitmix64 steps), so
    that neighbouring ops, draws and steps get unrelated seeds and salts."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (int(v) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def make_counter(seed: int, step: int, device) -> torch.Tensor:
    """A ``[seed, step]`` counter on ``device`` made by fill kernels, with
    no host copy, so a capture may run it."""
    return torch.cat([torch.full((1,), int(v), dtype=torch.int64,
                                 device=device) for v in (seed, step)])


def counter_key(counter: torch.Tensor) -> torch.Tensor:
    """The (1,) int64 base key, a uint32 value, of a ``[seed, step]``
    counter tensor, on the counter's device."""
    c = counter.reshape(-1).to(torch.int64)
    seed, step = c[:1], c[1:2]
    k = _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))
    k = _mix32(k ^ (step & _M32))
    return _mix32(k ^ ((step >> 32) & _M32))


def op_key(base: torch.Tensor, salt: int) -> torch.Tensor:
    """The (1,) int64 key of one draw: ``base`` (counter_key) mixed with a
    host salt (``mix`` of the draw's place in the program)."""
    return _mix32(_mix32(base ^ (int(salt) & _M32)))


def fold(key: torch.Tensor, i: int) -> torch.Tensor:
    """A key derived from ``key`` and the integer ``i`` (a sub-draw, such
    as attention dropout's KV block), as jax.random.fold_in derives one."""
    return op_key(key, mix(i))


def _shr(x, s):
    """Logical right shift of an int32 tensor."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def uniform24(key: torch.Tensor, shape) -> torch.Tensor:
    """An int32 tensor of ``shape`` whose elements are uniform on [0, 2**24):
    the top 24 bits of murmur3's finalizer of (element index * golden +
    key), on the key's device."""
    n = 1
    for s in shape:
        n *= int(s)
    k32 = (key - ((key >> 31) << 32)).to(torch.int32)
    x = torch.arange(n, dtype=torch.int32, device=key.device) * _GOLDEN + k32
    x = x ^ _shr(x, 16)
    x = x * _C1
    x = x ^ _shr(x, 13)
    x = x * _C2
    x = x ^ _shr(x, 16)
    return _shr(x, 8).reshape(tuple(shape))


def keep_mask(key: torch.Tensor, shape, p: float) -> torch.Tensor:
    """A bool tensor of ``shape``, each element True with probability
    1 - p (to 2**-24), a function of ``key`` alone."""
    return uniform24(key, shape) >= int(round(float(p) * (1 << 24)))
