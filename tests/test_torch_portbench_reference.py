"""The port against the benchmark's plain reference at tiny widths on the
CPU (``portbench/tests/test_portbench_reference.py``), collected here so
that the suite holds every change to the port to it.  One module per file:
both portbench files define module fixtures named ``spmm`` and ``rxn``."""

from portbench.tests.test_portbench_reference import *  # noqa: F401,F403
