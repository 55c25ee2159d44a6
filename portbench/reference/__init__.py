"""The benchmark's plain reference: frozen copies of the port's host
decoder (`decode`, the numpy chunk walk) and of its host encoder in its
pure-Python form (`encoder.encode_image`), importing nothing of the port."""
