"""Command-line entry points of the port (``jcf_tpu/cli``)."""
