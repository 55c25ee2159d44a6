"""The comparison that decides `correct`.

Decode: each answer kept from the window (every answer for a sample of the
pool's streams drawn from the seed) against the plain reference decoder's
pixels of that stream (`reference.decoder.decode`, run here, after the
window). Encode: every stream the window produced against the committed
stream the plain reference encoder made of the same image, both in their
zstd-independent canonical form (`reference.canonical`), and its size
against that stream's size. The pixels and the canonical forms are exact:
those numbers have the limit 0. The size may differ by what two zstd
library versions do at the configuration's level 18: `size_over_pct`, the
widest by which a stream is larger than the reference's, has a limit set
between that (sound runs on the card, libzstd 1.5.5 against the pool's
1.5.4) and the program at a lower zstd level (the control, PERF.md). An
RGBA stream's ALPM payload is compressed at the best of zstd levels 5-21,
which that limit cannot tell from level 5 alone (0.1-0.9% of a stream,
PERF.md): `alpm_over_sweep_pct`, the widest share by which an ALPM payload
is larger than what the reference's own sweep (`reference.alpha`) makes of
the same payload with this machine's libzstd, is exact, limit 0, and absent
where no stream has ALPM. An answer that never came (a call that raised, a
batch that returned fewer answers) counts as missing.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import alpha, canonical, decoder, zstd
from portbench.reference.headers import AlphaHeader

LIMITS = {"pixels_differing": 0, "streams_differing": 0,
          "answers_missing": 0, "size_over_pct": 3.5,
          "alpm_over_sweep_pct": 0}


def decode_checks(kept: dict, streams: list, lut: bytes,
                  reference=decoder.decode) -> dict:
    """{number: value}: pixel values that differ from the reference's, and
    answers missing, over every kept answer."""
    differing = missing = checked = 0
    for i, answers in sorted(kept.items()):
        ref = reference(streams[i], lut)
        for a in answers:
            if a is None:
                missing += 1
                continue
            checked += 1
            a = np.asarray(a)
            differing += (int(np.count_nonzero(a != ref))
                          if a.shape == ref.shape else ref.size)
    return {"pixels_differing": differing, "answers_missing": missing,
            "answers_checked": checked}


def alpm_payload(stream: bytes):
    """(The ALPM chunk's compressed payload, its decompressed size), or None
    where the stream has no ALPM chunk."""
    for tag, _, body in decoder.iter_chunks(stream):
        if tag == b"ALPM":
            hdr = AlphaHeader.unpack(body)
            n = AlphaHeader.size()
            return (body[n:n + hdr.stream_size],
                    hdr.expected_decompression_size)
    return None


def encode_checks(kept: dict, golden: list) -> dict:
    """{number: value}: streams whose canonical form differs from the
    reference's stream of that image (or that do not parse), the widest
    share (%) by which a stream is larger than the reference's stream of
    that image, the widest share by which an equal stream's ALPM payload is
    larger than the reference's level sweep makes it here (None without
    ALPM), and answers missing."""
    differing = missing = checked = 0
    over = alpm_over = None
    for i, answers in sorted(kept.items()):
        ref = canonical.canonical(golden[i])
        ref_alpm = alpm_payload(golden[i])
        if ref_alpm is not None:
            best = len(alpha._zstd_sweep(zstd.decompress(*ref_alpm)))
        for a in answers:
            if a is None:
                missing += 1
                continue
            checked += 1
            a = bytes(a)
            try:
                same = canonical.canonical(a) == ref
            except ValueError:
                same = False
            differing += not same
            pct = 100.0 * (len(a) - len(golden[i])) / len(golden[i])
            over = pct if over is None else max(over, pct)
            if same and ref_alpm is not None:
                pct = 100.0 * (len(alpm_payload(a)[0]) - best) / best
                alpm_over = pct if alpm_over is None else max(alpm_over, pct)
    return {"streams_differing": differing, "size_over_pct": over,
            "alpm_over_sweep_pct": alpm_over,
            "answers_missing": missing, "answers_checked": checked}


def verdict(numbers: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) for the numbers that have a
    limit; answers_checked rides along as a count with no limit, and
    correct also needs it above 0."""
    shown = {k: {"value": v, "limit": LIMITS[k]}
             for k, v in numbers.items() if k in LIMITS and v is not None}
    ok = (all(v["value"] <= v["limit"] for v in shown.values())
          and numbers.get("answers_checked", 0) > 0)
    shown["answers_checked"] = {"value": numbers.get("answers_checked", 0),
                                "limit": "> 0"}
    return ok, shown
