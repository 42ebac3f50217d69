"""The benchmark's own tests: run from the repository's root with
``python -m pytest -q portbench/tests``. They put ``portbench/`` and
``src/`` on the import path."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.join(os.path.dirname(BENCH), "src")]
