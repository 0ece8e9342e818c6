"""The paper's switched-capacitor IMC projection (Eq. 6): the CUDA
kernel's wrapper and its plain PyTorch version."""
