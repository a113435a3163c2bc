"""The benchmark's own tests: put portbench/ and the repository root on
the path, as portbench/run.py does."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
