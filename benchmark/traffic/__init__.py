"""Traffic kinds: ``<kind>.py`` drives one kind of cell (``run(cell)``)."""
