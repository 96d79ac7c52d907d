"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last lines on standard error, each number the correctness
check compared beside its limit, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits
non-zero, printing no result, without as many CUDA devices as the cell
asks for, or if JAX or the JAX package was loaded.
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
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Run from the checkout's root, not from this folder, whose module
    # names (trace, traffic) would shadow others.
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    import torch
    t_torch = time.perf_counter()
    from bench import harness, registry
    chips = int(registry.cell(args.workload)["chips"])
    clock = harness.SetupClock(T_START)
    clock.marks.append(("import_torch", t_torch))
    clock.mark("import_bench")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    clock.mark("cuda_init")
    # One process, one host thread for PyTorch's CPU operators: the host's
    # share of a solve is small tensors, and idle worker threads only add
    # jitter (on an H100, block GS on the paper's problem ran faster with it
    # in 4 of 4 pairs).
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), clock=clock)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
