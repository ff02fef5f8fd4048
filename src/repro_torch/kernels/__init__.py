"""The port's kernels: hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, their ctypes wrappers, the plain PyTorch versions in
:mod:`~repro_torch.kernels.ref`, and the device dispatch in
:mod:`~repro_torch.kernels.ops`."""
