"""The benchmark's yardstick: the manifest, the request generator, the
system under test's adapter, the trace reduction, the kernel bounds and the
comparison that decides ``correct``.  `run.py` drives it."""
