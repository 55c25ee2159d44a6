"""setup_s (s): process start to the first timed call: import torch, the
CUDA context, the kernel libraries from the build cache, the bank and
inputs, and the warm-up of every input through the entry point."""


def read(run):
    return run.setup_s
