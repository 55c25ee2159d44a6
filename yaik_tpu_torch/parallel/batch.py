"""Batch, spatial and corpus decode: the counterpart of
`yaik_tpu/parallel/batch.py`.

- `decode_batch` decodes same-size streams as one device step. The JAX
  package vmaps `decode_core` over the stacked operands; here the operands
  carry a leading batch axis (`pack.stack_args`) and every kernel launches
  once for the whole batch.
- `split_plan_bands` / `decode_spatial` cut one large image's plan into
  horizontal bands (every plan tensor is indexed by the tile grid, so bands
  are slices; the corner grids carry their one-row halo). On one card the
  equal bands are one batch.
- `decode_corpus` pipelines a corpus: streams grouped by size, planned
  and packed on the host (on a thread pool if asked), uploaded, and batch
  k+1 queued on the card before batch k is downloaded.

A batch must share one structure, as the JAX package's stacked pytrees
must: T3 and 2DTL take forms the whole batch can share
(`pack.uniform_forms`); streams with alpha decode alpha on the card when
they share one alpha spec, else it is decoded on the host and attached
after; mixing sizes, or streams with and without an overlay, plane
gradients or 2DTL raises ValueError, as there, and so does alpha beside
no alpha in `decode_batch` (`decode_corpus` takes that batch, as the JAX
package's does).

Sharding over several devices, the JAX package's `mesh=` over a "data"
axis: each entry point takes `devices=`, a list of torch devices in the
mesh's place (`data_devices(n)` lists the first n cards, as `data_mesh(n)`
makes a mesh of the first n devices). The forms are chosen over the whole
batch first, as the JAX package chooses them before it shards; then the
batch's streams (or bands) are split into `len(devices)` equal slices,
slice i is stacked, uploaded and decoded on `devices[i]`, and the
slices' pixels come back to the host by their own `.cpu()` and are
joined in order. As there, no collective is needed: no tensor of one
device is read on another. A list may name one device more than once;
its slices then run one after another on it. Where the JAX package's
sharding refuses a split, the port raises ValueError: a `decode_batch`
whose size the device count does not divide, `decode_spatial` bands that
are unequal or that it does not divide, a `decode_corpus` batch_size
that it does not divide (a short last batch is not padded: its slices
differ by at most one stream). `device=` beside `devices=` raises.

There is no fallback: "cuda" without a GPU raises, a kernel that fails
to build or launch raises, and a slice that fails raises and is not
moved to another device.
"""
from __future__ import annotations

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yaik_tpu_torch.decoder import api, engine, pack
from yaik_tpu_torch.decoder import planner as plannermod
from yaik_tpu_torch.utils import profiler

__all__ = ["data_devices", "decode_batch", "split_plan_bands",
           "decode_spatial", "decode_corpus"]


def data_devices(n: int | None = None) -> list[torch.device]:
    """The first `n` cards (default: every card present) as the
    `devices=` of the entry points: the counterpart of `data_mesh`. Raises
    when fewer cards are present than asked for; it never lists the CPU
    or a card twice in their place."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if not 1 <= n <= have:
        raise RuntimeError(f"data_devices({n}): {have} CUDA devices "
                           "present")
    return [torch.device("cuda", i) for i in range(n)]


def split(items: list, n: int) -> list[list]:
    """`items` in at most `n` consecutive slices, in order, whose sizes
    differ by at most one; no slice is empty."""
    q, r = divmod(len(items), n)
    starts = [i * q + min(i, r) for i in range(n + 1)]
    return [items[a:b] for a, b in zip(starts, starts[1:]) if b > a]


def over_slices(fn, jobs: list) -> list:
    """`[fn(*job) for job in jobs]`: the slices of a split dispatched one
    after another from the calling thread, while the devices run those
    queued before. (A thread a slice measured slower on an H100's host,
    PERF.md §6; chip_smoke.py swaps it in here to time it.)"""
    return [fn(*job) for job in jobs]


def batch_forms(plans: list, tables: engine.Tables, args: list | None = None
                ) -> tuple:
    """(each stream's `pack.DecodeArgs` in forms the batch shares, whether
    alpha is left to the host) for `plans` of same-size streams; `args` are
    their `plan_to_args`, when packed already. Alpha stays on the card when
    every stream has it and all share one alpha spec (JAX:
    `_common_alpha_spec`, where no alpha is a spec of its own); else every
    stream decodes RGB on the card and `with_host_alpha` attaches the
    host's alpha to those that have it."""
    w, h = plans[0].width, plans[0].height
    if any(p.width != w or p.height != h for p in plans):
        raise ValueError("decode_batch requires same-sized streams")
    with profiler.stage("decode:forms"):
        if args is None:
            args = [pack.plan_to_args(p, tables.lut, tables.lut2)
                    for p in plans]
        args = pack.uniform_forms(plans, args, tables.lut, tables.lut2)
        host_alpha = len({a.alpha.spec if a.alpha else None
                          for a in args}) > 1
        if host_alpha:
            args = [dataclasses.replace(a, alpha=None) for a in args]
        return args, host_alpha


def batch_operands(plans: list, tables: engine.Tables, args: list | None = None
                   ) -> tuple:
    """(`batch_forms`'s args stacked into one `pack.DecodeArgs`, whether
    alpha is left to the host)."""
    args, host_alpha = batch_forms(plans, tables, args)
    return pack.stack_args(args), host_alpha


def with_host_alpha(rgb: np.ndarray, plan: plannermod.DecodePlan,
                    host_alpha: bool) -> np.ndarray:
    """One image's [H, W, 3|4] pixels from the card, with the plan's
    host-decoded alpha attached where its batch left alpha to the host."""
    if not (host_alpha and plan.has_alpha):
        return rgb
    return np.concatenate([rgb, plan.host_alpha()[:, :, None]], axis=2)


def _tables(lut, device, devices) -> tuple:
    """(the bank of `lut`, its `engine.Tables` on each device the call
    runs on)."""
    devs = engine.devices_of(device, devices)
    bank = api.bank_of(lut)
    return bank, [api._TABLES.get(bank, d) for d in devs]


def _decode_slice(args: list, tables: engine.Tables, flags: dict
                  ) -> torch.Tensor:
    """Stack, upload and queue the decode of one slice on its tables'
    device; returns before the device has finished."""
    with profiler.stage("decode:stack"):
        stacked = pack.stack_args(args)
    stacked = engine.upload(stacked, tables.tab.device)
    with profiler.stage("decode:dispatch"):
        return engine.decode_core(stacked, tables, **flags)


def _dispatch_split(plans: list, tables: list, flags: dict,
                    args: list | None = None) -> tuple:
    """Queue the decode of one batch split over the devices of `tables`
    (an `engine.Tables` each): (each slice's pixels on its device, whether
    alpha is left to the host)."""
    args, host_alpha = batch_forms(plans, tables[0], args)
    jobs = [(a, t, flags) for a, t in zip(split(args, len(tables)), tables)]
    return over_slices(_decode_slice, jobs), host_alpha


def _join(parts: list, plans: list, host_alpha: bool) -> np.ndarray:
    """The slices' pixels on the host, in order: [B, H, W, 3|4] u8 (each
    `.cpu()` waits for its device)."""
    with profiler.stage("decode:download"):
        out = np.concatenate([engine.to_host(p) for p in parts])
    if not host_alpha:
        return out
    return np.stack([with_host_alpha(o, p, True) for o, p in zip(out, plans)])


def _decode(plans: list, tables: list, flags: dict, args: list | None = None
            ) -> np.ndarray:
    """One batch split over the devices of `tables`, synchronously."""
    parts, host_alpha = _dispatch_split(plans, tables, flags, args)
    return _join(parts, plans, host_alpha)


def decode_batch(streams: list, lut, device=engine.CARD, t3_d1: bool = False,
                 grad_final: bool = False, devices: list | None = None
                 ) -> np.ndarray:
    """Decode same-size streams as one batch on `device` (the card unless
    the caller asks for "cpu"), or split over `devices`: [B, h, w, 3] u8,
    or [B, h, w, 4] when the streams carry alpha. `lut` takes what
    `decode_image` takes; `t3_d1` and `grad_final` choose the fused forms
    (`engine.decode_core`)."""
    bank, tables = _tables(lut, device, devices)
    if len(streams) % len(tables):
        raise ValueError(f"decode_batch over {len(tables)} devices: the "
                         f"batch of {len(streams)} does not split into "
                         "equal slices")
    with profiler.stage("decode:batch"):
        with profiler.stage("decode:plan"):
            plans = [plannermod.build_plan(s, bank.expanded,
                                           bank.expanded2d) for s in streams]
        withalpha = [p.has_alpha for p in plans]
        if any(withalpha) and not all(withalpha):
            raise ValueError("decode_batch cannot mix alpha/non-alpha "
                             "streams in one batch")
        return _decode(plans, tables, dict(t3_d1=t3_d1,
                                           grad_final=grad_final))


def split_plan_bands(plan: plannermod.DecodePlan, n_bands: int) -> list:
    """Slice a decode plan into <= n_bands horizontal bands. Band starts
    are 16px-aligned (the largest tile grid, 16x16 gradients), so every
    pass's tile grid splits cleanly; the LAST band absorbs the remainder
    and may be shorter (real 4K: 2160 = 3x544 + 528). Carries every plan
    field but alpha (`decode_spatial` attaches the full plan's): gradient
    passes (plane variants included), 3D passes, the UCOL/SMAP overlay,
    2DTL passes and the 1D residual. A copy of the JAX package's
    `split_plan_bands` on the port's planner records."""
    h, w = plan.height, plan.width
    bh_nom = -(-(-(-h // n_bands)) // 16) * 16    # ceil(h/n) up to 16-mult
    if bh_nom >= h:
        return [plan]
    bands = []
    for y0 in range(0, h, bh_nom):
        bh = min(bh_nom, h - y0)
        grads = []
        for g in plan.gradient:
            th = 1 << g.shift[1]
            q0, q1 = y0 // 4, (y0 + bh) // 4
            grads.append(plannermod.GradientPassPlan(
                shift=g.shift, accept=g.accept[y0 // th:(y0 + bh) // th],
                corners=g.corners[q0:q1 + 1], plane_mask=g.plane_mask))
        t3 = []
        for p in plan.tile3d:
            tw, th = 1 << p.shift[0], 1 << p.shift[1]
            ntx = w // tw
            r0, r1 = (y0 // th) * ntx, ((y0 + bh) // th) * ntx
            t3.append(plannermod.Tile3DPassPlan(
                shift=p.shift, accept=p.accept[y0 // th:(y0 + bh) // th],
                colors=p.colors[r0:r1], packed=p.packed[r0:r1],
                types=p.types[r0:r1] if p.types is not None else None))
        t2 = None
        if plan.tile2d:
            t2 = []
            for p in plan.tile2d:
                tw, th = 1 << p.shift[0], 1 << p.shift[1]
                ntx = w // tw
                r0, r1 = (y0 // th) * ntx, ((y0 + bh) // th) * ntx
                t2.append(plannermod.Tile2DPassPlan(
                    mode=p.mode, shift=p.shift,
                    accept=p.accept[y0 // th:(y0 + bh) // th],
                    types=p.types[r0:r1], colors=p.colors[r0:r1],
                    packed=p.packed[r0:r1]))
        overlay = None
        if plan.overlay is not None:
            overlay = plannermod.PlanOverlay(
                vals=plan.overlay.vals[y0:y0 + bh],
                mask=plan.overlay.mask[y0:y0 + bh])
        ntx8 = w // 8
        r0, r1 = (y0 // 8) * ntx8, ((y0 + bh) // 8) * ntx8
        d1 = plannermod.Plan1D(params=plan.d1.params[:, r0:r1],
                               indices=plan.d1.indices[:, r0:r1],
                               wmask=plan.d1.wmask[:, r0:r1])
        bands.append(plannermod.DecodePlan(
            width=w, height=bh, gradient=grads, tile3d=t3, d1=d1,
            overlay=overlay, tile2d=t2))
    return bands


def decode_spatial(stream: bytes, lut, device=engine.CARD,
                   n_bands: int | None = None, t3_d1: bool = False,
                   grad_final: bool = False, devices: list | None = None
                   ) -> np.ndarray:
    """Decode ONE image in `n_bands` horizontal bands (default one per
    device: 1 on `device`, `len(devices)` over `devices`): the equal bands
    as one batch, a shorter last band on its own; over `devices` the bands
    must be equal, and split over the devices. Returns [h, w, 3] u8
    ([h, w, 4] with alpha, decoded on the host from the full plan),
    pixel-equal to `decode_image`."""
    bank, tables = _tables(lut, device, devices)
    plan = plannermod.build_plan(stream, bank.expanded, bank.expanded2d)
    n = n_bands or len(tables)
    bands = split_plan_bands(plan, n)
    if devices is not None and len({b.height for b in bands}) != 1:
        raise ValueError(
            "mesh-sharded spatial decode needs equal bands: image height "
            f"{plan.height} does not split into {n} equal 16px-multiple "
            "bands (drop devices= or pick a dividing n_bands)")
    if len(bands) % len(tables):
        raise ValueError(f"decode_spatial over {len(tables)} devices: "
                         f"{len(bands)} bands do not split into equal "
                         "slices")
    flags = dict(t3_d1=t3_d1, grad_final=grad_final)
    parts = []
    for _, group in itertools.groupby(bands, key=lambda b: b.height):
        group = list(group)
        # bands carry no alpha; one band is the plan itself, alpha dropped
        args = [dataclasses.replace(pack.plan_to_args(
            b, tables[0].lut, tables[0].lut2), alpha=None) for b in group]
        out = _decode(group, tables, flags, args)
        parts.append(out.reshape(-1, *out.shape[2:]))
    rgb = np.concatenate(parts, axis=0)
    if plan.has_alpha:
        rgb = np.concatenate([rgb, plan.host_alpha()[:, :, None]], axis=2)
    return rgb


@dataclasses.dataclass
class _InFlight:
    """A dispatched batch: its streams' indices and plans, and its slices'
    pixels on their devices, where the devices may still be writing
    them."""
    chunk: list
    plans: list
    parts: list
    host_alpha: bool


def _dispatch(chunk, plans_args, tables, flags) -> _InFlight:
    """Stack, upload and queue the decode of one batch, split over the
    devices of `tables`; returns before the devices have finished."""
    plans = [p for p, _ in plans_args]
    parts, host_alpha = _dispatch_split(plans, tables, flags,
                                        [a for _, a in plans_args])
    return _InFlight(chunk, plans, parts, host_alpha)


def _drain(job: _InFlight, results: list) -> None:
    with profiler.stage("decode:drain"):
        pixels = np.concatenate([engine.to_host(p)                # waits
                                 for p in job.parts])
        for j, i in enumerate(job.chunk):
            results[i] = with_host_alpha(pixels[j], job.plans[j],
                                         job.host_alpha)


def decode_corpus(streams: list, lut, batch_size: int = 8,
                  planner_workers: int = 1, device=engine.CARD,
                  t3_d1: bool = False, grad_final: bool = False,
                  devices: list | None = None) -> list:
    """Pipelined decode of a corpus: the streams grouped by the size in
    their headers, decoded in batches of up to `batch_size` (a short last
    batch is not padded), while the host plans and packs the next batch
    (the end-to-end bottleneck) on `planner_workers` threads. The default
    is one: packing holds the GIL, and on an 8-core H100 host eight
    threads measured no faster than one (PERF.md). Returns each stream's
    [h, w, 3|4] u8 pixels in input order, equal to `decode_image`'s. A
    batch may mix alpha with no alpha, or alpha specs: it then decodes RGB
    on the card and attaches the host's alpha, as the JAX package does.
    Over `devices`, each batch is split over them, and every slice of
    batch k+1 is queued before batch k is downloaded. Each batch counts
    one `decode_batches` and its streams in `decode_batch_streams`."""
    if batch_size < 1:
        raise ValueError(f"batch_size {batch_size} < 1")
    bank, tables = _tables(lut, device, devices)
    if batch_size % len(tables):
        raise ValueError(f"batch_size {batch_size} must be a multiple of "
                         f"the {len(tables)} devices")
    flags = dict(t3_d1=t3_d1, grad_final=grad_final)

    def plan_and_pack(i):       # on the calling thread or a planner thread
        with profiler.stage("decode:plan-pack", parent=here):
            with profiler.stage("decode:plan"):
                plan = plannermod.build_plan(streams[i], bank.expanded,
                                             bank.expanded2d)
            return plan, pack.plan_to_args(plan, tables[0].lut,
                                           tables[0].lut2)

    with profiler.stage("decode:corpus"):
        with profiler.stage("decode:group"):     # size from the header alone
            groups: dict = {}
            for i, s in enumerate(streams):
                w, h, _ = api.decode_image_pre(s)
                groups.setdefault((w, h), []).append(i)
            chunks = [idxs[k:k + batch_size] for idxs in groups.values()
                      for k in range(0, len(idxs), batch_size)]
        pool = (ThreadPoolExecutor(planner_workers) if planner_workers > 1
                else None)
        results: list = [None] * len(streams)
        pending = None
        here = profiler.current()
        try:
            for chunk in chunks:
                # planning batch k+1 here overlaps the card's work on batch k
                planned = list(pool.map(plan_and_pack, chunk) if pool
                               else map(plan_and_pack, chunk))
                job = _dispatch(chunk, planned, tables, flags)
                profiler.count("decode_batches")
                profiler.count("decode_batch_streams", len(chunk))
                if pending is not None:
                    _drain(pending, results)
                pending = job
            if pending is not None:
                _drain(pending, results)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return results
