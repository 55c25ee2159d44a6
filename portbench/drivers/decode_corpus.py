"""Corpus decode: `yaik_tpu_torch.parallel.batch.decode_corpus` of a call's
streams, one answer (pixels on the host) per stream."""
KIND = "decode"


def entry(inputs, device, **kw):
    from yaik_tpu_torch.parallel.batch import decode_corpus
    return lambda idx: decode_corpus(
        [inputs.streams[i] for i in idx], inputs.lut_bank, device=device,
        **kw)
