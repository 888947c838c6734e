"""The benchmark of the PyTorch and CUDA port (``repro_torch``).  Run one
cell with ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the checkout's root
names the cells."""
