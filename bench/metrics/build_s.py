"""build_s: host seconds of ``csr_from_arrays`` and the first use of the
operator's padded views, synchronised (layer: operator build)."""


def read(run):
    return run.build_s
