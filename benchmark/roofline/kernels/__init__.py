"""One module a work item of the port's hand kernels (``roofline/work.py``)."""
