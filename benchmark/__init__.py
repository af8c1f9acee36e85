"""The port's benchmark: one cell a run (``run.py``), everything else found
by name under this folder (``README.md``)."""
