"""vln_imagine_tpu_torch: the PyTorch/CUDA port of vln_imagine_tpu for NVIDIA
Hopper (H100).

The JAX package beside it is the reference; every module here mirrors its
counterpart's path and names and is held against it by the tests
(`tests/test_torch_*.py`).  This package imports torch, numpy and the
standard library only.  Its attention kernel is CUDA C++ for sm_90a
(`csrc/attention_fwd.cu`), built at first use.
"""
