"""On-demand decode: `yaik_tpu_torch.decode_image` of one stream per item,
each answer the pixels on the host."""
KIND = "decode"


def entry(inputs, device, **kw):
    import yaik_tpu_torch
    return lambda idx: [yaik_tpu_torch.decode_image(
        inputs.streams[i], inputs.lut_bank, device=device, **kw)
        for i in idx]
