"""Runnable demos of the port (counterparts of the repo's ``examples/`` that
drive the device plane)."""
