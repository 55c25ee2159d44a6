"""encode_mpix_s (MPix/s): pixels of the images encoded into finished
streams in the window, over the whole window."""
from portbench.harness import readers


def read(run):
    if run.kind != "encode":
        return None
    return readers.mpix(run) / run.window_s
