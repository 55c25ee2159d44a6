"""Corpus encode: `yaik_tpu_torch.encoder.batch.encode_corpus` of a call's
images, one finished stream per image."""
KIND = "encode"


def entry(inputs, device, **kw):
    from yaik_tpu_torch.encoder.batch import encode_corpus
    return lambda idx: encode_corpus(
        [inputs.images[i] for i in idx], inputs.bank3d,
        config=inputs.encoder_config, device=device, **kw)
