"""Counter-based random stream: keys are int64 tensors, every draw a pure
function of its key.

The JAX package threads ``jax.random`` keys through its state: one key per
request from its seed, split once at prefill (the first token's draw) and
into three at each round (the next key, the acceptance uniforms, the bonus
draw).  The port keeps that structure with its own stream: a key is an
int64 tensor on the device (shape ``[]`` for one request, ``[B]`` for a
slot-stacked state, so keys stack and latch like any other state field),
and ``split`` / ``uniform`` / ``gumbel`` are chains of splitmix64 steps on
it.  Nothing reads the host or a global generator, so a round stays free of
host reads whatever its batch, and the same key gives the same bits on the
CPU and on the card (integer hashing has no rounding; the uniforms are
multiples of 2^-24, exact in float32).

The stream is not JAX's: at T > 0 the port's tokens agree with the JAX
package's in distribution, not bit for bit.  Every draw is split into
"noise from a key" and "a deterministic function of the noise"
(``tree.sampling_accept`` takes uniforms, ``sampling.categorical`` takes
Gumbel noise), so tests can hand the JAX package's own noise to the port.
"""

from __future__ import annotations

import math

import torch


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 value with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """One splitmix64 step (wrapping int64 arithmetic)."""
    z = z + _GOLDEN
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def key(seed: int, device="cuda") -> torch.Tensor:
    """The key of ``seed``: an int64 scalar tensor on ``device``."""
    return _mix(torch.tensor(int(seed), dtype=torch.int64, device=device))


def keys(seeds, device="cuda") -> torch.Tensor:
    """Keys of several seeds, stacked ``[len(seeds)]`` (one per slot)."""
    return _mix(torch.as_tensor(list(seeds), dtype=torch.int64, device=device))


def split(k: torch.Tensor, n: int):
    """``n`` new keys from ``k`` (a tuple of tensors shaped like ``k``)."""
    sub = _mix(k.unsqueeze(-1) ^ _mix(torch.arange(1, n + 1, dtype=torch.int64,
                                                   device=k.device)))
    return sub.unbind(-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """int64 random bits ``k.shape + shape``: one hash of (key, counter)."""
    shape = tuple(shape)
    ctr = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape)
    return _mix(k.reshape(k.shape + (1,) * len(shape)) ^ _mix(ctr))


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniforms in [0, 1), multiples of 2^-24, ``k.shape + shape``."""
    return _srl(bits(k, shape), 40).to(torch.float32) * 2.0 ** -24


def open_unit(b23: torch.Tensor) -> torch.Tensor:
    """23-bit integers -> float32 in the open interval (0, 1): the midpoints
    of a 2^-23 grid, all exact in float32 (a 24-bit grid's last midpoint
    would round to 1.0)."""
    return (b23.to(torch.float32) + 0.5) * 2.0 ** -23


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard Gumbel noise ``k.shape + shape``: -log(-log(u)) with
    u in (0, 1), finite everywhere."""
    return -torch.log(-torch.log(open_unit(_srl(bits(k, shape), 41))))
