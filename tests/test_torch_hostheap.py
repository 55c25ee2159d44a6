"""The host heap's policy (yaik_tpu_torch.utils.hostheap): once held, a
process that allocates and frees the same large buffers over and over
reuses its heap instead of faulting the pages in again each round, and the
device decode holds it. Each policy check runs in a clean interpreter, so
nothing this test process allocated before decides the heap's state."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import yaik_tpu_torch
from yaik_tpu_torch.utils import hostheap

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).parent.parent

# Eight 10 MB buffers made, filled and freed five times; prints what hold()
# gave and the minor page faults of each round after the first.
ROUNDS = """
import resource, sys
sys.path.insert(0, {root!r})
import numpy as np
from yaik_tpu_torch.utils import hostheap
held = hostheap.hold()
faults = []
for r in range(5):
    f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    bufs = [np.ones(10 << 20, np.uint8) for _ in range(8)]
    del bufs
    faults.append(resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0)
print(held, max(faults[1:]))
"""


def _rounds(**env) -> tuple:
    clean = {k: v for k, v in os.environ.items()
             if k not in hostheap.ENV and k != "GLIBC_TUNABLES"}
    out = subprocess.run([sys.executable, "-c", ROUNDS.format(root=str(ROOT))],
                         env={**clean, **env}, capture_output=True,
                         text=True, check=True).stdout.split()
    return out[0] == "True", int(out[1])


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="the policy is glibc's mallopt")
def test_held_heap_keeps_freed_buffers_mapped():
    held, faults = _rounds()
    assert held
    # a round that faulted its 80 MB back in would count 20,480 4 KiB pages
    assert faults < 1000, faults


def test_environment_policy_is_left_alone():
    held, _ = _rounds(MALLOC_TRIM_THRESHOLD_=str(1 << 20))
    assert not held


def test_device_decode_holds_the_heap(monkeypatch):
    calls = []
    monkeypatch.setattr(hostheap, "hold", lambda: calls.append(1))
    stream = (FIX / "img64.yaik").read_bytes()
    lut = (FIX / "LutFile.lut").read_bytes()
    host = yaik_tpu_torch.decode_image(stream, lut, engine="host")
    assert calls == []
    out = yaik_tpu_torch.decode_image(stream, lut, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(out, host)
