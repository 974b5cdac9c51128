"""The repository's convergence study on the port (counterpart of
``convergence_test/``): ``python -m
navierstokes_tpu_torch.convergence_test.taylor_green_vortex``."""
