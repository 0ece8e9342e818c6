"""Flash attention (causal and sliding-window GQA, forward and backward):
the CUDA kernels' wrappers, the differentiable op and its plain
versions."""
