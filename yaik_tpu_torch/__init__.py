"""yaik_tpu_torch: the PyTorch and CUDA port of yaik_tpu's device decode (every
chunk family the JAX engine decodes, RGB and RGBA), device-scored encode
(RGB and RGBA, every pass) and LUT-bank mining, with the JAX package's host
engines, its C-ABI decoder library and its research analyzers.

It runs the per-pixel decode, the encoder's tile scoring and the miner's
coverage matrix on an NVIDIA
H100 with kernels written by hand in CUDA C++ (`ops/csrc/`). It is
self-contained: it imports neither jax nor anything of the JAX package
`yaik_tpu`, and keeps its own copies of the framework-neutral host modules
it uses, each at its counterpart's relative path (`format/`, `entropy/`,
`native/` with the C-ABI decoder library, `decoder/reference.py`,
`decoder/planner.py`, the host half of `decoder/alpha.py`,
`encoder/bank.py`, `encoder/context.py`, `encoder/gradient.py`,
`encoder/corr3d.py`, `encoder/dyn1d.py`, `encoder/palette_codec.py`, the
encoder's host passes `encoder/alpha.py`, `single_color.py`,
`smooth_map.py`, `corr2d.py`, `bank2d.py`, `plnt.py`, `ops/plane.py`, and
the analyzers `encoder/analysis.py`, `ops/segments.py`). Its native host
library builds with g++ at first use into `build/yaik_tpu_torch/`; without
it the pure-Python twins run.

`decode_image(stream, lut, device, t3_d1=False, grad_final=False)`: the two
keywords choose the fused standard decode (`t3_merged_d1` and
`grad_plane_final`, two launches), the counterparts of the JAX package's
`YAIK_T3_D1` and `YAIK_GRAD_FINAL`; both are off by default there and here.
`parallel.batch` decodes many streams: `decode_batch` (same-size streams
as one batch, each kernel launched once for it), `decode_spatial` (one
image in horizontal bands, the equal bands as one batch) and
`decode_corpus` (grouped by size, planned on the host, batch k+1 queued
on the card before batch k is downloaded). `encoder.batch` encodes many
images: `encode_batch` (same-shape images as one batch, each scoring kernel
launched once per 3D pass for it, only the accept bits and the accepted
tiles' rows downloaded), `encode_corpus` (grouped by shape, batches queued
on the card ahead of the host's emission, caps grown where content
overflows them) and `encode_image_banded` (one image in 16-row bands).
`encode_image` takes RGB and RGBA images and every pass of the JAX
package (the alpha chunks; UCOL, SMAP, plane-subset gradients, 2D with
`bank2d=`, PLNT where the config turns them on), scoring the RGB planes on
the card and running those passes on the host, as the JAX device engine
does. `decoder.engine.decode_plnt_plane` reconstructs a PLNT plane from
`decoder.pack.plnt_args`. `encoder.mining` mines LUT banks from a corpus,
the coverage matrix on the card (`ops/csrc/covers.cu`).

`engine="host"` on `decode_image`, `encode_image` and the miner runs the
JAX package's numpy host engines instead (the reference decoder, the host
gradient and 3D scorers, numpy coverage): no tensor and no card, the same
pixels, bytes and files, and an oracle for the card that shares no code
with its kernels. The device engine is the default of every entry point.
`native.capi` builds and binds `libyaik_tpu`, the C-ABI host decoder for
C and C++ callers (`native/include/yaik_tpu.h`). Every encode compresses
an image's zstd streams on one thread per core (what the JAX package does
under YAIK_ZSTD_WORKERS; the same bytes).

Layout:
  format/, entropy/    - stream structs, swizzle, LUT files, zstd, palette
  native/              - ctypes binding of the host library (yaik_host.cpp);
                         capi.py: the C-ABI decoder library (yaik_capi.cpp)
  decoder/reference.py - the numpy host decoder (engine="host")
  decoder/planner.py   - stream -> DecodePlan (host)
  decoder/pack.py      - plan -> DecodeArgs, the kernels' operands (numpy)
  decoder/engine.py    - decode_core: every decode stage as torch ops + kernels
  decoder/alpha.py     - the alpha plane of an RGBA stream (torch, and host)
  decoder/api.py       - LutBank, assign_lut, decode_image (engine="device"
                         or "host"), decode_image_pre
  parallel/batch.py    - decode_batch, split_plan_bands, decode_spatial,
                         decode_corpus
  encoder/bank.py      - load_bank: the 3D LUT bank's points and factors
                         (the host scorer's maps built at first use)
  encoder/corr3d.py    - the host 3D scorer; PERMS48, SWAP3D
  encoder/tables.py    - the 3D LUT bank as the scoring kernels take it
  encoder/scoring.py   - gradient and 3D pass scoring of an image or a
                         batch, with the alive-tile cap (torch + kernels)
  encoder/pipeline.py  - the passes on the device: one image, dense; a batch,
                         packed and compacted; the compaction's host side
  encoder/emit.py      - 3D stream emission from the scoring results, dense
                         or compacted (numpy)
  encoder/context.py, gradient.py, dyn1d.py, palette_codec.py
                       - host emission: chunks, GTIL / 2DTL streams, 1D,
                         palette; the host gradient scorer
  encoder/alpha.py, single_color.py, smooth_map.py, corr2d.py, bank2d.py,
  plnt.py              - the host passes: MIPM/ALPM, UCOL, SMAP, 2D, PLNT
  ops/plane.py         - the pixel-plane functions of those passes (numpy)
  encoder/analysis.py, ops/segments.py
                       - the research analyzers, segment-list LUT contexts
  encoder/api.py       - encode_image(rgb, bank, device, config=None,
                         bank2d=None, engine="device")
  encoder/batch.py     - encode_batch, encode_corpus, encode_image_banded
  encoder/mining.py    - mine_bank, mine_bank2d: LUT-bank mining (either
                         engine)
  ops/kernels.py       - kernel wrappers beside their plain torch versions
  ops/build.py         - nvcc build at first use into build/yaik_tpu_torch/
  entry.py             - entry(stream, lut, device): (fn, example_args), a
                         stream's decode on the card, for harnesses
                         (__graft_entry__.entry)
  convert.py           - the JAX engine's operands -> the port's, for tests
"""

from yaik_tpu_torch.decoder.api import LutBank, assign_lut, decode_image  # noqa: F401
from yaik_tpu_torch.encoder.api import encode_image  # noqa: F401
