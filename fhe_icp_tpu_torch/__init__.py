"""PyTorch/CUDA port of the JAX FHE package: RNS-BGV encrypted packed search.

The JAX package beside this one is the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch; the NTT and the fused
scoring kernel are CUDA C++ for sm_90a (`csrc/`, built by `kernels.py`).
"""
