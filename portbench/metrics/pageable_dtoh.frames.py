"""Device-to-pageable-host copies a frame launched under the program's
spans: each is a host wait outside ``host_fetch`` (whose copies go to
pinned memory), such as a ``.item()`` or a tensor's truth value."""

from portbench import program_spans


def read(trace, info):
    n = program_spans.frames(trace, info)
    if n is None:
        return None
    return sum(1 for o in trace.ops if not o.kernel and "DtoH" in o.name
               and "Pageable" in o.name and o.span.startswith(program_spans.PREFIX)) / n
