"""The training runtime (``runtime.fault_tolerance``)."""
