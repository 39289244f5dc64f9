"""Domain decomposition over a mesh of shard devices, and the multi-process
bring-up (counterpart of ``pde_solver_tpu.parallel``)."""
