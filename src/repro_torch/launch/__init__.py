"""Step builders for the port's entry points (``launch/steps.py``)."""
