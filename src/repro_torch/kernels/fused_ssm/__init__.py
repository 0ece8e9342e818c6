"""The fused selective scan (Mamba-1 SSM core, forward and backward): the
CUDA kernels' wrappers, the differentiable op and its plain versions."""
