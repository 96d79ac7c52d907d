"""host_us_per_record: the engine's own host work a record, in µs: host
time inside the program's ``repro_torch.solve_batched`` spans less the time
inside its ``repro_torch.engine.wait`` spans (the blocking reads to the
host, all inside ``solve_batched`` in a cell's units), over the traced
records (layer: engine).  Reads ``Trace.program_s`` (``bench/spans.py``);
nothing where the trace or the program has no spans."""


def read(run):
    spans = getattr(run.trace, "program_s", None) or {}
    records = sum(u.records for u in run.units if u.traced)
    solve = spans.get("repro_torch.solve_batched")
    if not solve or records == 0:
        return None
    return 1e6 * (solve - spans.get("repro_torch.engine.wait", 0.0)) / records
