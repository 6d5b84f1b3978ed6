#!/usr/bin/env python3
"""Runs `chip_smoke.py` with each line it prints to standard output stamped
with the seconds since the start, to show where the script's time goes (a
phase's time is the gap between its line and the one before it).

    python3 tools/time_chip_smoke.py > stamped.txt

Run from the root of the repository on the card, as `chip_smoke.py` is run.
It exits with the script's code.
"""
import builtins
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import chip_smoke

    start = time.perf_counter()
    real = builtins.print

    def stamped(*args, **kwargs):
        if kwargs.get("file") in (None, sys.stdout):
            args = (f"[{time.perf_counter() - start:7.1f} s]",) + args
        real(*args, **kwargs)

    builtins.print = stamped
    try:
        return chip_smoke.main()
    finally:
        builtins.print = real


if __name__ == "__main__":
    sys.exit(main())
