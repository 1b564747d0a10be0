"""The training data of the port (``data.pipeline``)."""
