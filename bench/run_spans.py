"""Run one cell once, traced, with the program's spans reduced.

    python3 bench/run_spans.py --workload <cell> --seed <n> --seconds <s>

As ``run.py --trace 1`` (``spans.run_cell``): the result line's metrics
are the cell's per-layer metrics and the span families that list it
(``spans.METRICS``: ``host_us_per_record``, ``engine_idle_us_per_record``,
``stream_ops_per_record``), and ``program`` gives, per traced record, the
host µs, self µs and card-idle µs by span, the stream operations by span,
the spans' counts and the share of ``solve_batched``'s host time its
child spans cover.  Exits non-zero, printing no result, without as many
CUDA devices as the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    import torch

    from bench import harness, registry, spans
    chips = int(registry.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.set_num_threads(1)            # as run.py
    result = spans.run_cell(args.workload, args.seed, args.seconds,
                            clock=harness.SetupClock(T_START))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
