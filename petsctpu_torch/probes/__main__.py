"""python -m petsctpu_torch.probes [case ...] [--device cpu]

Runs the probe cases (all by default) on the card, or with --device cpu
on the kernels' plain versions, and prints one line per case."""

from __future__ import annotations

import argparse

from petsctpu_torch.probes import CASES, run


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m petsctpu_torch.probes",
        description="The round-4 TPU probe kernels as Hopper kernels H1-H3.")
    ap.add_argument("cases", nargs="*", metavar="case",
                    help=f"cases to run (default: all): {', '.join(CASES)}")
    ap.add_argument("--device", default=None,
                    help="device (default: cuda; cpu runs the plain "
                         "versions and times nothing)")
    args = ap.parse_args(argv)
    return run(args.cases, device=args.device)


if __name__ == "__main__":
    main()
