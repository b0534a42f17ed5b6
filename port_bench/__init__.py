"""The benchmark of the PyTorch/CUDA port `mpc_collisionavoidance_tpu_torch`
on one NVIDIA H100: `python3 -m port_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` (see README.md)."""
