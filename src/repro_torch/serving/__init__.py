"""Edge serving (port of ``repro.serving``): the scheduler so far."""
