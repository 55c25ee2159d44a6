"""decode_mpix_s (MPix/s): pixels of the streams decoded in the window
(on the host, in the order asked), over the whole window."""
from portbench.harness import readers


def read(run):
    if run.kind != "decode":
        return None
    return readers.mpix(run) / run.window_s
