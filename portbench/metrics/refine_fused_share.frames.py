"""Share of the traced slice's two-view polishes that ran as the one fused
kernel: 100 x the program's counter ``refine.fused`` over ``refine.calls``
(both in ``sfm/two_view_refine.py``).  A program without the counters
leaves nothing to read."""

from portbench import program_spans


def read(trace, info):
    if not program_spans.traced(trace):
        return None
    try:
        from niftymatch_torch.utils.profiling import counts
    except ImportError:
        return None
    c = counts()
    calls = c.get("refine.calls", 0)
    return 100.0 * c.get("refine.fused", 0) / calls if calls else None
