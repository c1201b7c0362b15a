"""The benchmark of the PyTorch and CUDA port (`fhe_icp_tpu_torch`): `python3 -m portbench.run`."""
