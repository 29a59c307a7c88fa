"""The benchmark of the PyTorch and CUDA port (``unet_convlstm_tpu_torch``)
on one H100: ``python3 -m port_bench.run`` runs one cell of
``BENCHMARK.json``. See ``port_bench/README.md``."""
