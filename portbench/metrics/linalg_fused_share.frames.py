"""Share of the traced slice's small-matrix solves (``svd3x3`` and
``smallest_eigvec``) that ran as one launch of ``csrc/linalg.cu``: 100 x
the program's counter ``linalg.fused`` over ``linalg.calls`` (both in
``geometry/linalg.py``).  A program without the counters leaves nothing to
read."""

from portbench import program_spans


def read(trace, info):
    if not program_spans.traced(trace):
        return None
    try:
        from niftymatch_torch.utils.profiling import counts
    except ImportError:
        return None
    c = counts()
    calls = c.get("linalg.calls", 0)
    return 100.0 * c.get("linalg.fused", 0) / calls if calls else None
