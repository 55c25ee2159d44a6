"""The fixed cost of one encode, ms: the mean of the port's root span
`encode:image` over the window's calls whose image is at most 256x256
pixels (a mip chain's six smallest levels), the k-th root span of the
window being the k-th call. None where the window holds no such call, or
where root spans and calls do not pair one to one."""
from portbench.harness import program

program.watch()

MAX_PIXELS = 256 * 256


def read(run):
    p = program.profile(run)
    if p is None:
        return None
    roots = sorted((e for e in p.events
                    if e.name == "encode:image" and e.parent == 0),
                   key=lambda e: e.start_ns)
    if len(roots) != len(run.calls):
        return None
    got = [e.end_ns - e.start_ns for e, c in zip(roots, run.calls)
           if c.ok and all(run.item_pixels[i] <= MAX_PIXELS
                           for i in c.items)]
    return sum(got) / len(got) / 1e6 if got else None
