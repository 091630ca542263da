"""Hand-written CUDA kernels of the port (sources in ``csrc/``), built by
``_build.py`` on first use."""
