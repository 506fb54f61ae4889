"""The finish's (B2's) share of its roofline, in percent, in the traced
recording: the least time of the finish work on the slices' dynamic
windows over B2's summed device time.

The work is counted from the program's counter ``window_px`` (the
windows' pixels, summed over iterations) with ``portbench.roofline``: the
image pair read once (12 B a pixel: an int64 time sum and an int32 count)
and ``ops_finish`` operations a pixel.  B2 is the kernel the profiler
names ``iteration_kernel`` (B2's template instance of ``iteration.cuh``;
on the fast split drive no other instance runs), which ``tracing`` keeps
among the ten operations that took the most device time."""

from portbench import roofline

B2 = "iteration_kernel"
PAIR_BYTES = 12


def _b2_seconds(ops):
    return sum(s for name, s in ops
               if name.removeprefix("void ").strip() == B2)


def read(layer):
    t = layer.get("trace")
    p = layer.get("program", {})
    px = p.get("counters", {}).get("window_px")
    if not t or not px:
        return None
    b2 = _b2_seconds(t["device_ops"])
    if not b2:
        return None
    least = roofline.bound_s(PAIR_BYTES * px,
                             roofline.ops_finish(px, p["scale"]))
    return 100.0 * least / b2
