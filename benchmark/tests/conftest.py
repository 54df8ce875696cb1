"""CPU tests of the benchmark's harness. Run from the repository's root:

    python -m pytest benchmark/tests -q

They import the port only where they hold the frozen transmitter to it
or drive a run on the CPU; tests marked ``gpu`` need a CUDA card and
skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
