"""Entry points of the port: the paper's experiment (``paper``)."""
