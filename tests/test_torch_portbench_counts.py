"""The benchmark's counts of needed work against ``FlopCounterMode`` on the
port's own modules (``portbench/tests/test_portbench_counts.py``), collected
here so that the suite holds every change to the port to them."""

from portbench.tests.test_portbench_counts import *  # noqa: F401,F403
