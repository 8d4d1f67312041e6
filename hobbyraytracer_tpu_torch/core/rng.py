"""Sampling discipline: jax.random's threefry keys, folded by (purpose,
iteration), drawn bit for bit as the JAX package draws them.

Counterpart of hobbyraytracer_tpu/core/rng.py. A `Sampler(seed, device)`
holds the two uint32 words of jax.random.PRNGKey(seed), (0, seed mod
2**32). Key operations are host work on those two words
(kernels/threefry.py: threefry2x32 on Python ints): `fold_in(i)` is
jax.random.fold_in, `split(n)` jax.random.split, and `stream(purpose,
iteration)` the reference's rng.stream, fold_in(fold_in(key, purpose),
iteration). Every draw is one threefry draw per uniform (the CUDA kernel
csrc/threefry.cu on the card, its plain version on the CPU), so the port
draws what the JAX package draws:

- `uniform(purpose, iteration, shape)` = rng.uniform(rng.stream(key,
  purpose, iteration), shape), and likewise `unit_sphere`, `in_ball` and
  `in_disk`, which split their key as the reference does (two uniforms;
  in_ball calls unit_sphere on the first half of its split);
- `randint(purpose, iteration, shape, high)` = jax.random.randint(stream,
  shape, 0, high) for int32, returned as int64;
- `key_uniform(shape)` / `key_randint(shape, high)` draw from the
  sampler's key itself (jax.random.uniform(key), randint(key)), for the
  call sites that draw from a folded or split key rather than a stream.

The iteration may be a host int or a 0-d int32 tensor on the sampler's
device. With a tensor, the fold by the iteration and every fold after it
run on the device inside the draw (a `Key` carries them), so a replayed
CUDA graph draws new numbers each iteration without a host round trip.
Likewise a key's words may live on the device: `KeySlot` is a (2,) int32
buffer that the host fills with a key's words, and `Sampler.slotted(slot)`
draws from it. Its folds, splits and streams are carried as the path of
host folds after the slot's words, so a graph captured once draws under
whatever key the host wrote into the slot before each replay (the batch
integrator's samples, integrator/path.py). A slot made with `folds=n`
also holds the key's folds by 0 .. n-1, which the host writes beside the
words: a slotted key's first fold by such a value reads its words from
there, so a stream (purpose, iteration) may fold by a device iteration
after the purpose (the wavefront render's kept block graph,
integrator/wavefront.py).

span=(offset, total) on a draw (reference core/rng.py:33-55): the rows
offset:offset+n of the full (total, ...) draw, n the leading size of
`shape`, bit for bit. Element i of a draw takes counter i, so the slice is
a counter offset: only its own rows are drawn.

The sphere, ball and disk maps are the reference's elementwise formulas on
those uniforms; cos, sin, sqrt and cbrt (here a pow) are the library's, so
their last bits may differ from XLA's.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..kernels import threefry as tf

# Stable purpose tags, the same numbers as the reference's.
PIXEL_JITTER_U = 0
PIXEL_JITTER_V = 1
SCATTER_SPHERE = 2   # unit-sphere offsets (lambertian/metal/dielectric fuzz)
SCATTER_BALL = 3     # isotropic phase function
DIELECTRIC_CHOICE = 4
MEDIUM_FLIGHT = 5
LENS = 6
RUSSIAN_ROULETTE = 7
STREAM_TAGS = 8      # the render's streams take the purposes 0 .. 7
# edge sampling (diff/edges.py; the reference's tags, diff/edges.py:55-58)
EDGE_PICK = 201
EDGE_S = 202
EDGE_PICK_SH = 203
EDGE_S_SH = 204

_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Key:
    """A threefry key: `words` (two host ints, or the (2,) int32 device
    tensor of a KeySlot), folded by `it` when it is a 0-d int32 tensor,
    then by each value of `path`. With host words and no `it` the path is
    empty (host folds fold the words); otherwise each draw derives the key
    on the device. `folds`: the (n, 2) device words of the slot's key
    folded by 0 .. n-1 (KeySlot(folds=n)), for the key's first fold."""
    words: Union[tuple, torch.Tensor]
    it: Optional[torch.Tensor] = None
    path: tuple = ()
    folds: Optional[torch.Tensor] = None

    @property
    def on_device(self) -> bool:
        """Are the folds carried to the draw (device words or `it`)?"""
        return self.it is not None or isinstance(self.words, torch.Tensor)

    def fold_in(self, data) -> "Key":
        """jax.random.fold_in(key, data): data a host int (taken mod
        2**32) or, once, a 0-d int32 tensor."""
        if isinstance(data, torch.Tensor):
            if self.it is not None or self.path:
                raise ValueError("a key takes one fold by a device value, "
                                 "before any host fold of a slot")
            if data.dim() != 0:
                raise ValueError(f"a device fold takes a 0-d tensor, got "
                                 f"shape {tuple(data.shape)}")
            return Key(self.words, data, self.path)
        data = int(data) & _M32
        if not self.on_device:
            return Key(tf.fold(self.words, data))
        if (self.folds is not None and self.it is None and not self.path
                and data < self.folds.shape[0]):
            return Key(self.folds[data])
        return Key(self.words, self.it, self.path + (data,))

    def split(self, n: int) -> list:
        """jax.random.split(key, n): key i is fold_in(key, i)."""
        return [self.fold_in(i) for i in range(n)]


def _draw_geometry(shape, span):
    """(elements, counter offset) of a draw of `shape`, or of its rows
    offset:offset+n of a (total,) + shape[1:] draw."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if span is None:
        return n, 0
    off, total = int(span[0]), int(span[1])
    if not shape or off < 0 or off + shape[0] > total:
        raise ValueError(f"span {tuple(span)} does not hold {shape[:1]} "
                         f"rows")
    return n, off * math.prod(shape[1:])


class KeySlot:
    """A key's two words in device memory: a (2,) int32 tensor on `device`
    that `fill` writes a host key's words into. Draws from
    Sampler.slotted(slot) (and from its folds, splits and streams) read the
    words there when they run, so a CUDA graph that captured them draws
    under the key of the last fill before each replay. With `folds` = n the
    slot also holds the key folded by each of 0 .. n-1 (`folds`, (n, 2)),
    which a slotted key's first fold reads. `fill` writes on the device's
    current stream, outside any graph."""

    def __init__(self, device, folds: int = 0):
        table = torch.zeros((1 + folds, 2), dtype=torch.int32, device=device)
        self.words = table[0]
        self.folds = table[1:] if folds else None

    def fill(self, key: Key) -> None:
        """Write the host words of `key` (and its folds) into the slot."""
        if key.on_device:
            raise ValueError("a key slot takes a key of host words")
        rows = [(self.words, key.words)]
        if self.folds is not None:
            rows += [(self.folds[d], tf.fold(key.words, d))
                     for d in range(self.folds.shape[0])]
        for row, words in rows:
            for i, w in enumerate(words):
                row[i].fill_(w - (w >> 31 << 32))   # as int32


class Sampler:
    """Random draws for one render, jax.random's bit for bit (see the
    module docstring): `uniform` / `unit_sphere` / `in_ball` / `in_disk`
    return float32 tensors on `device`, `randint` int64 ones, each from the
    stream of (purpose, iteration); each takes span=(offset, total) for a
    slice of a larger batch's draw."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        # jax.random.PRNGKey(seed): the high word 0, the low word the seed
        # mod 2**32
        self.key = Key((0, int(seed) & _M32))

    def _with_key(self, key: Key) -> "Sampler":
        out = copy.copy(self)
        out.key = key
        return out

    # ---------------------------------------------------------------- keys

    def fold_in(self, index) -> "Sampler":
        """The Sampler of jax.random.fold_in(key, index): one sample of the
        batch integrator, one chunk of its samples, one worker."""
        return self._with_key(self.key.fold_in(index))

    def slotted(self, slot: KeySlot) -> "Sampler":
        """This sampler drawing under the key held in `slot`."""
        return self._with_key(Key(slot.words, folds=slot.folds))

    def split(self, n: int) -> list:
        """The Samplers of jax.random.split(key, n)."""
        return [self._with_key(k) for k in self.key.split(n)]

    def stream(self, purpose: int, iteration) -> "Sampler":
        """The Sampler of rng.stream(key, purpose, iteration)."""
        return self._with_key(self.key.fold_in(purpose).fold_in(iteration))

    # --------------------------------------------------------- key draws

    def _draw(self, key: Key, shape, span, floats: bool) -> torch.Tensor:
        """One threefry draw of `shape` (float32 uniforms, or int64 bits)."""
        n, offset = _draw_geometry(shape, span)
        out = tf.threefry_draw(key.words, key.it, key.path, n, offset,
                               floats, self.device)
        return out.reshape(tuple(shape))

    def _uniform(self, key: Key, shape, span=None) -> torch.Tensor:
        return self._draw(key, shape, span, True)

    def _unit_sphere(self, key: Key, shape, span=None) -> torch.Tensor:
        k1, k2 = key.split(2)
        return _on_sphere(self._uniform(k1, shape, span),
                          self._uniform(k2, shape, span))

    def _in_ball(self, key: Key, shape, span=None) -> torch.Tensor:
        k1, k2 = key.split(2)
        d = self._unit_sphere(k1, shape, span)
        u = self._uniform(k2, shape, span)
        return d * torch.pow(u, 1.0 / 3.0)[..., None]

    def _in_disk(self, key: Key, shape, span=None) -> torch.Tensor:
        k1, k2 = key.split(2)
        r = torch.sqrt(self._uniform(k1, shape, span))
        phi = self._uniform(k2, shape, span) * (2.0 * math.pi)
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)

    def _randint(self, key: Key, shape, high: int, span=None) -> torch.Tensor:
        """jax.random.randint(key, shape, 0, high) for int32: two draws of
        bits (split(key) halves), combined in uint32 arithmetic."""
        high = int(high)
        if high >= 2 ** 31:
            raise ValueError(f"randint high {high} exceeds int32")
        k1, k2 = key.split(2)
        hi = self._draw(k1, shape, span, False)
        lo = self._draw(k2, shape, span, False)
        rng = max(high, 1)   # maxval <= minval draws minval
        mult = (2 ** 16) % rng                   # every product wraps at 2**32
        mult = ((mult * mult) & _M32) % rng
        off = (((hi % rng) * mult) & _M32) + (lo % rng)
        return (off & _M32) % rng

    def key_uniform(self, shape, span=None) -> torch.Tensor:
        """U[0, 1) float32 from the key itself (jax.random.uniform(key))."""
        return self._uniform(self.key, shape, span)

    def key_randint(self, shape, high: int, span=None) -> torch.Tensor:
        """Integers uniform in [0, high) from the key itself
        (jax.random.randint(key, shape, 0, high)), int64."""
        return self._randint(self.key, shape, high, span)

    # ------------------------------------------------------ stream draws

    def _stream_key(self, purpose: int, iteration) -> Key:
        return self.key.fold_in(purpose).fold_in(iteration)

    def uniform(self, purpose: int, iteration, shape,
                span=None) -> torch.Tensor:
        """U[0, 1) float32 (glm::linearRand(0, 1))."""
        return self._uniform(self._stream_key(purpose, iteration), shape,
                             span)

    def randint(self, purpose: int, iteration, shape, high: int,
                span=None) -> torch.Tensor:
        """Integers uniform in [0, high), int64 (jax.random.randint)."""
        return self._randint(self._stream_key(purpose, iteration), shape,
                             high, span)

    def unit_sphere(self, purpose: int, iteration, shape,
                    span=None) -> torch.Tensor:
        """Uniform on the unit sphere (glm::sphericalRand(1)): shape + (3,),
        from z = 2*U1 - 1 and phi = 2*pi*U2 as in the reference."""
        return self._unit_sphere(self._stream_key(purpose, iteration), shape,
                                 span)

    def in_ball(self, purpose: int, iteration, shape,
                span=None) -> torch.Tensor:
        """Uniform inside the unit ball (glm::ballRand(1)): shape + (3,), a
        unit-sphere direction times cbrt(U3), as in the reference."""
        return self._in_ball(self._stream_key(purpose, iteration), shape,
                             span)

    def in_disk(self, purpose: int, iteration, shape,
                span=None) -> torch.Tensor:
        """Uniform inside the unit disk (the thin lens): shape + (2,),
        r = sqrt(U1) and phi = 2*pi*U2 as in the reference."""
        return self._in_disk(self._stream_key(purpose, iteration), shape,
                             span)


def _on_sphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    z = u1 * 2.0 - 1.0
    phi = u2 * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
