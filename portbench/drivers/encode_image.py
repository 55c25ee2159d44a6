"""One-image encode: `yaik_tpu_torch.encode_image` of one image per item,
each answer the finished stream."""
KIND = "encode"


def entry(inputs, device, **kw):
    import yaik_tpu_torch
    return lambda idx: [yaik_tpu_torch.encode_image(
        inputs.images[i], inputs.bank3d, device=device,
        config=inputs.encoder_config, **kw) for i in idx]
