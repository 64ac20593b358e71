"""The benchmark of the PyTorch and CUDA port (``meshrecon_torch``) on an
NVIDIA H100. ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``README.md`` says how
to add a configuration, a traffic mix, a metric or a cell."""
