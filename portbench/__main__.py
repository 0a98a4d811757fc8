"""`python3 -m portbench ...`: `run.py`'s `main`, which pins the run's
environment the same way whichever command starts it."""

import sys

from portbench import run

sys.exit(run.main())
