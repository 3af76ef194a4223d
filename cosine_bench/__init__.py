"""The benchmark of the PyTorch and CUDA port (`repro_torch`): run a cell
with `python3 cosine_bench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>` from the root of a checkout."""
