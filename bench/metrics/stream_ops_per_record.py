"""stream_ops_per_record: the host's calls that put work on a stream
(kernel launches, asynchronous copies and sets: ``spans.STREAM_CALLS``)
inside the program's ``repro_torch.solve_batched`` spans, over the traced
records (layer: dispatch seam).  Reads ``Trace.program_stream_ops``
(``bench/spans.py``); nothing without card operations in the trace or
without the program's spans."""


def read(run):
    t = run.trace
    ops = getattr(t, "program_stream_ops", None) or {}
    records = sum(u.records for u in run.units if u.traced)
    if t is None or t.events == 0 or "repro_torch.solve_batched" not in ops \
            or records == 0:
        return None
    return ops["repro_torch.solve_batched"] / records
