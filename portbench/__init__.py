"""The benchmark of the PyTorch and CUDA port (``torchregister_tpu_torch``):
cells of ``BENCHMARK.json`` run by ``python3 -m portbench.run``."""
