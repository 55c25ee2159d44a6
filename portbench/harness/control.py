"""The controls: what the check must refuse.

The configurations state no floating-point precision; they state two
guarantees, and each control breaks one, in the step that would tempt a
faster version:

- Decode is exact: every pixel equals the reference decoder's. The decode
  control is the plain reference decoder put in the program's place with
  its gradient tiles' bilinear fill taken in float16 (normalised weights,
  truncated), in place of the reference's exact integer blend.
- Encode keeps the configuration's reject factor (3): a tile is taken only
  where every pixel lies within it. The encode control is the program
  itself with `reject_factor` 4, a looser threshold that accepts more
  tiles and makes smaller, faster streams.
- Encode compresses every stream at the configuration's zstd level (18):
  small files are what the codec is for. The size control is the program
  itself with its zstd level 18 taken down to 9, which compresses several
  times faster and makes streams some 5% larger with the same content.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from portbench.reference import decoder


def _bilinear_tile_half(c00, c01, c10, c11, tw: int, th: int) -> np.ndarray:
    f = np.float16
    fy = (np.arange(th, dtype=f) / f(th))[:, None, None]
    fx = (np.arange(tw, dtype=f) / f(tw))[None, :, None]
    c = [np.asarray(x, f)[None, None, :] for x in (c00, c01, c10, c11)]
    top = c[0] * (f(1) - fx) + c[1] * fx
    bot = c[2] * (f(1) - fx) + c[3] * fx
    return np.clip(top * (f(1) - fy) + bot * fy, 0, 255).astype(np.uint8)


@contextlib.contextmanager
def _half_gradients():
    exact = decoder._bilinear_tile
    decoder._bilinear_tile = _bilinear_tile_half
    try:
        yield
    finally:
        decoder._bilinear_tile = exact


def decode_half(stream: bytes, lut: bytes) -> np.ndarray:
    """The reference decode with the float16 gradient fill."""
    with _half_gradients():
        return decoder.decode(stream, lut)


def decode_entry(lut: bytes):
    """An entry point for `harness.bench.run_cell(entry=...)`: the decode
    control in the program's place, for either decode traffic."""
    def make(_program_fn, inputs):
        return lambda idx: [decode_half(inputs.streams[i], lut) for i in idx]
    return make


def encode_entry(reject_factor: int = 4):
    """An entry point for `run_cell(entry=...)`: the program's own encode
    entry with the looser reject factor."""
    def make(program_fn, inputs):
        inputs.encoder_config = dataclasses.replace(
            inputs.encoder_config, reject_factor=reject_factor)
        return program_fn
    return make


@contextlib.contextmanager
def _zstd_level(level: int):
    from yaik_tpu_torch.encoder import context
    exact = context._compress_job
    context._compress_job = lambda job: exact(
        (job[0], min(job[1], level), job[2]))
    try:
        yield
    finally:
        context._compress_job = exact


def encode_level_entry(level: int = 9):
    """An entry point for `run_cell(entry=...)`: the program's own encode
    entry with each stream of zstd level 18 compressed at `level`."""
    def make(program_fn, inputs):
        def fn(idx):
            with _zstd_level(level):
                return program_fn(idx)
        return fn
    return make
