"""engine_idle_us_per_record: the card's idle time while the unit thread is
inside the program's ``repro_torch.solve_batched`` span, in µs, over the
traced records (layer: device): the card-idle seconds of every program
span (``Trace.program_idle_s``, by innermost span: each lies inside
``solve_batched`` in a cell's units).  With ``device_idle`` it splits the
card's idle time between the program and the harness.  Nothing without
card operations in the trace or without the program's spans."""


def read(run):
    t = run.trace
    idle = getattr(t, "program_idle_s", None) or {}
    spans = getattr(t, "program_s", None) or {}
    records = sum(u.records for u in run.units if u.traced)
    if t is None or t.events == 0 or "repro_torch.solve_batched" not in spans \
            or records == 0:
        return None
    return 1e6 * sum(idle.values()) / records
